"""PyTorch/CUDA port of the FERRARI reachability serving path.

Mirrors the layout of the reference JAX package (``graphs/``, ``core/``,
``kernels/``, ``reach/``, ``launch/``) and imports neither it nor JAX.
The host build and packing are numpy; phase 1 and the sparse phase 2 run
hand-written CUDA kernels (``csrc/``, built at first use) on an NVIDIA
Hopper card, or their plain PyTorch versions on CPU tensors.
"""

"""PyTorch/CUDA port of the FERRARI reachability serving path and of the
model paths of the reference package.

Mirrors the layout of the reference JAX package (``graphs/``, ``core/``,
``kernels/``, ``reach/``, ``models/``, ``optim/``, ``data/``,
``launch/``) and imports neither it nor JAX. The host build and packing
are numpy; phase 1, the sparse phase 2, the device build and the models'
hot spots run hand-written CUDA kernels (``csrc/``, built at first use)
on an NVIDIA Hopper card, or their plain PyTorch versions on CPU tensors.
"""

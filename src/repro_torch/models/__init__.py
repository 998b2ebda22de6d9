"""Model families the port runs: MIND recsys (interests and retrieval
scores, kernel 10), the GNN dense-batch forward (kernel 9), and the dense
LMs' prefill and decode (kernel 6) and training (kernels 6, 7 and 8)."""

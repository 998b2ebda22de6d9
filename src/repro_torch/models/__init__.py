"""Model families the port serves: MIND recsys (interests and retrieval
scores, kernel 10), the GNN dense-batch forward (kernel 9) and the dense
LMs' prefill and decode (kernel 6)."""

"""Model families the port serves: MIND recsys (interests and retrieval
scores, kernel 10) and the GNN dense-batch forward (kernel 9)."""

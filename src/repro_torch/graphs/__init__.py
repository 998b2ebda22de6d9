from .csr import CSR, build_csr, reverse_csr  # noqa: F401

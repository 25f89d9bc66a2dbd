"""Binary-PC-code RSA and its figure (port of ``experiments/binary_pc_rsa/``)."""

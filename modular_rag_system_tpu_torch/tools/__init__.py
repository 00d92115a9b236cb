"""Tools that build the encoder's assets with the port, run as ``python -m
modular_rag_system_tpu_torch.tools.<name>``."""

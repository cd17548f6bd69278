"""The LM model families of the port (``repro.models`` in PyTorch):
``model_api`` (configs, registry, params), ``layers``, and the families
``transformer``, ``rwkv6``, ``hybrid`` (with ``mamba``) and ``encdec``."""

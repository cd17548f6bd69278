"""Target-hardware constants of the port (``hw``): one NVIDIA H100."""

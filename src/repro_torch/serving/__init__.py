"""KRR serving on the port: the batched bucket scorer (``krr_serve``) and
the coalescing multi-model engine (``engine``), counterparts of
``repro.serving.krr_serve`` and ``repro.serving.engine``."""

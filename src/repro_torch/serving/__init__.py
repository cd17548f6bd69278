"""Serving on the port: the KRR bucket scorer (``krr_serve``), the
coalescing multi-model engine (``engine``) and the LM prefill / decode steps
with greedy generation (``serve_step``), counterparts of
``repro.serving.{krr_serve,engine,serve_step}``."""

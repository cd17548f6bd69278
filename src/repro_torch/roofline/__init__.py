"""The port's roofline: the H100's constants (``hw``), the dry run's cost
and memory tracing on meta tensors (``analyze``) and its tables
(``report``)."""

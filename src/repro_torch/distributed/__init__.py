"""The distributed KRR tier on the port: the single-controller solver mesh
(``meshes``), the row-sharded kernel operator (``sharded_operator``), the
distributed ASkotch / PCG solves (``krr_dist``) and the divide-and-conquer
tier with its partitions (``dc``, ``partition``) — counterparts of
``repro.distributed``."""

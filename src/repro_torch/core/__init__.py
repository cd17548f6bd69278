"""Problem container, kernel operators and the ASkotch / Skotch solvers."""

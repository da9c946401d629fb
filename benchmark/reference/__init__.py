"""The benchmark's plain references, one module per kind of answer,
named by a traffic mix's ``reference``: written from the definitions in
plain torch and numpy, they import neither JAX, nor the JAX package, nor
anything of the program, and work the state out again from the seeded
geometry (``system.py``: the cell, the Bloch functions, the
one-electron matrices, the Ewald energy; ``uhf.py``: the ISDF state and
the KUHF fixed point)."""

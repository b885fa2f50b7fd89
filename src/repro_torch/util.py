"""Small shared utilities.

Copy of ``repro.util.opt_flags``: the named options of ``REPRO_OPTS``
(``REPRO_OPTS=a,b,c``).  The port reads two of them: ``w8_experts``
(``models/moe.py``: int8 expert banks, dequantised at use) and
``remat_dots`` (``models/transformer.py``: the group checkpoint keeps
the outputs of products with no batch dimension, ``aten.mm`` and
``aten.addmm``, and recomputes the rest).
"""
import os


def opt_flags() -> set:
    """Named perf optimizations (REPRO_OPTS=a,b,c)."""
    v = os.environ.get("REPRO_OPTS", "")
    return {x.strip() for x in v.split(",") if x.strip()}

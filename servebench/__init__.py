"""servebench: the serving benchmark of the PyTorch/CUDA port.

One run serves one cell (a model configuration under a traffic mix)
through ``repro_torch``'s multi-replica ``EngineRuntime`` on the card
and prints one JSON line.  Everything a cell is made of is found by
name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``cells/<cell>.json`` and ``metrics/<metric>.py``.
"""

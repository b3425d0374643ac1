"""The port's benchmark: coded multi-model training of ``repro_torch`` on one
card, driven by data.

``run.py`` runs one cell (``cells/<cell>.json``: a configuration of
``configs/`` under a traffic mix of ``traffic/``) and prints one JSON line.
The per-layer metrics are readers of their own under ``metrics/``; the
plain reference that decides ``correct`` is ``reference/``.  Nothing here
imports JAX or the JAX package, and ``reference/`` imports nothing of the
port.
"""

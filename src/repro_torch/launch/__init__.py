"""Launchers: mesh construction, the multi-pod dry-run, the train / serve /
scenario CLIs.

``dryrun`` and ``perf`` are not imported here: they are entry points
(``python -m repro_torch.launch.dryrun``), though importing them sets nothing.
"""

from .mesh import make_local_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]

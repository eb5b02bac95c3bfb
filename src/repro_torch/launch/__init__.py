"""Entry points of the port: device meshes over ``torch.distributed``
(``launch/mesh.py``) and the specs that place runtime trees on them
(``launch/specs.py``), the one-card LM training launcher
(``launch/train.py``) and the analytic parameter and FLOP counts
(``launch/analytic.py``)."""

from repro_torch.launch.mesh import make_mesh, make_production_mesh

__all__ = ["make_mesh", "make_production_mesh"]

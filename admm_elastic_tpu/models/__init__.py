"""Constraint ("force") batches: struct-of-array element sets with batched
proximal projections — the batched replacement for the reference's
per-object virtual-dispatch Force hierarchy (Force.hpp:37-57)."""

from .base import ForceBatch
from .spring import Spring
from .anchor import StaticAnchor, MovingAnchor
from .tet import LinearTetStrain, TetVolume, HyperElasticTet
from .triangle import LimitedTriangleStrain, FungTriangle, TriArea
from .bend import Bend
from .collision import Collision, Floor, Sphere, Cylinder
from .explicit import ExplicitForce, WindForce

__all__ = [
    "ForceBatch",
    "Spring",
    "StaticAnchor", "MovingAnchor",
    "LinearTetStrain", "TetVolume", "HyperElasticTet",
    "LimitedTriangleStrain", "FungTriangle", "TriArea",
    "Bend",
    "Collision", "Floor", "Sphere", "Cylinder",
    "ExplicitForce", "WindForce",
]

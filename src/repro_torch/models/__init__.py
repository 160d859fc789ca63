from .config import ArchConfig, MoESpec, SSMSpec, SHAPES, ShapeConfig, \
    shape_applicable  # noqa: F401
from .model import Model, build_model  # noqa: F401

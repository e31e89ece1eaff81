"""Scene/config layer: reads the reference's XML dialect (two root elements,
<mclScene> + <admmelastic>) and builds a System from it — the JAX-framework
equivalent of mclscene's SceneManager + the reference's ForceBuilder/SimContext
glue (src/SimContext.cpp, src/ForceBuilder.cpp)."""

from .params import Param, Component, compose_xform
from .parser import parse_scene_file, SceneConfig
from .context import SimContext

__all__ = ["Param", "Component", "compose_xform", "parse_scene_file",
           "SceneConfig", "SimContext"]

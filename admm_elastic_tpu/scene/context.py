"""SimContext: scene-file -> running simulation.

The JAX-framework equivalent of the reference's binding layer
(src/SimContext.cpp + src/ForceBuilder.cpp): loads a scene XML, creates
geometry for every object, appends dynamic objects' vertices/masses to the
System, instantiates constraint batches from the named <Force> definitions,
adds global explicit forces (gravity/wind/static anchors), and offers
step/update just like mcl::Simulator.

Differences by design:
  * no GL renderer — `update()` refreshes host-side mesh copies and
    `export_obj()` dumps frames for offline visualization;
  * per-type constraint batching: all tets of an object become ONE
    LinearTetStrain batch instead of thousands of Force objects;
  * wind-face offsets use the true per-object system offsets (the reference
    iterates an unordered_map to accumulate offsets, SimContext.cpp:131-162,
    which is only correct for single-object scenes).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.system import Settings, System
from ..geometry.connectivity import extract_hinges, unique_edges
from ..geometry.masses import lump_masses_tets, lump_masses_tris, lump_masses_uniform
from ..geometry.primitives import (
    make_box,
    make_cylinder,
    make_sphere,
    make_sym_plane,
    make_torus,
)
from ..geometry.tetmesh import TetMesh, load_mesh_as_tets, load_node_ele
from ..geometry.trimesh import TriMesh, load_obj, load_ply
from ..models import (
    Bend,
    ExplicitForce,
    HyperElasticTet,
    LimitedTriangleStrain,
    LinearTetStrain,
    Spring,
    StaticAnchor,
    TetVolume,
    WindForce,
)
from .params import Component, Param, compose_xform
from .parser import SceneConfig, parse_scene_file


@dataclasses.dataclass
class SceneObject:
    """A scene object + its system-node range (empty range if static)."""

    component: Component
    mesh: object  # TriMesh or TetMesh
    faces: np.ndarray  # render/surface triangles (local indices)
    index_offset: int = -1  # first system node (-1: static, not in system)
    n_nodes: int = 0

    @property
    def is_dynamic(self) -> bool:
        return self.index_offset >= 0

    @property
    def vertices(self) -> np.ndarray:
        return self.mesh.vertices


def _build_geometry(obj: Component, base_dir: str):
    """Create the object's mesh (DefaultBuilders.hpp:50-341 equivalents)."""
    t = obj.type.lower()
    if t == "plane":
        w = obj.get("width").as_int() if obj.exists("width") else 1
        l = obj.get("length").as_int() if obj.exists("length") else 1
        return make_sym_plane(w, l)
    if t == "cylinder":
        tl = obj.get("tess_l").as_int() if obj.exists("tess_l") else 10
        tc = obj.get("tess_c").as_int() if obj.exists("tess_c") else 10
        r = obj.get("radius").as_double() if obj.exists("radius") else 1.0
        return make_cylinder(tl, tc, r)
    if t == "sphere":
        tess = obj.get("tess").as_int() if obj.exists("tess") else 16
        r = obj.get("radius").as_double() if obj.exists("radius") else 1.0
        return make_sphere(tess, r)
    if t in ("box", "beam", "cube"):
        tess = obj.get("tess").as_int() if obj.exists("tess") else 1
        return make_box(tess)
    if t == "torus":
        tess = obj.get("tess").as_int() if obj.exists("tess") else 16
        inner = obj.get("inner_radius").as_double() if obj.exists("inner_radius") else 0.25
        outer = obj.get("outer_radius").as_double() if obj.exists("outer_radius") else 1.0
        return make_torus(tess, inner, outer)
    if t == "tetmesh":
        fn = obj.get("file").as_str()
        path = fn if os.path.isabs(fn) else os.path.join(base_dir, fn)
        # Reference TetMesh::load semantics: a .node/.ele pair loads
        # directly; a surface file (.ply/.obj) falls back to
        # tetrahedralization (deps/mclscene/src/TetMesh.cpp:47-64,376-435).
        return load_mesh_as_tets(path)
    if t in ("trimesh", "mesh"):
        fn = obj.get("file").as_str()
        path = fn if os.path.isabs(fn) else os.path.join(base_dir, fn)
        if path.endswith(".ply"):
            return load_ply(path)
        return load_obj(path)
    if t == "pointcloud":
        fn = obj.get("file").as_str()
        path = fn if os.path.isabs(fn) else os.path.join(base_dir, fn)
        m = load_node_ele(path) if path.endswith(".node") else load_ply(path)
        return TriMesh(np.asarray(m.vertices), np.zeros((0, 3), np.int32))
    raise ValueError(f"unknown object type {obj.type!r} for {obj.name!r}")


def _make_constraints(obj_mesh, faces, force: Component, offset: int):
    """XML force type -> constraint batches (ForceBuilder.cpp:76-446)."""
    ftype = force.type.lower()
    out = []

    def req(tag):
        if not force.exists(tag):
            raise ValueError(
                f"**ForceBuilder Error: force {force.name!r} needs a {tag} parameter"
            )
        return force.get(tag)

    if ftype in ("lineartrianglestrain", "trianglestrain"):
        stiffness = req("stiffness").as_double()
        lim = (0.0, 9999999.0)
        if force.exists("limit"):
            v = force.get("limit").as_vec2()
            lim = (float(v[0]), float(v[1]))
        out.append(
            LimitedTriangleStrain(
                faces + offset, stiffness, limit_min=lim[0], limit_max=lim[1],
            )
        )
    elif ftype == "bend":
        stiffness = req("stiffness").as_double()
        hinges = extract_hinges(faces)
        if len(hinges):
            out.append(Bend(hinges + offset, stiffness))
    elif ftype == "spring":
        stiffness = req("stiffness").as_double()
        edges = unique_edges(faces)
        if len(edges):
            out.append(Spring(edges + offset, stiffness))
    elif ftype == "lineartetstrain":
        stiffness = req("stiffness").as_double()
        ws = force.get("weight_scale").as_double() if force.exists("weight_scale") else 1.0
        out.append(LinearTetStrain(obj_mesh.tets + offset, stiffness,
                                   weight_scale=ws))
    elif ftype in ("neohookeantet", "stvktet"):
        mu = req("mu").as_double()
        lam = req("lambda").as_double()
        it = force.get("max_iterations").as_int() if force.exists("max_iterations") else 10
        model = "nh" if ftype == "neohookeantet" else "stvk"
        out.append(HyperElasticTet(obj_mesh.tets + offset, mu, lam, it, model))
    elif ftype == "volpres":
        out.append(
            TetVolume(
                obj_mesh.tets + offset,
                req("stiffness").as_double(),
                limit_min=req("range_min").as_double(),
                limit_max=req("range_max").as_double(),
            )
        )
    elif ftype != "constforce":
        raise ValueError(f"unsupported force type {force.type!r}")
    return out


class SimContext:
    """Owns one System + the scene it was built from."""

    def __init__(self, settings: Settings | None = None):
        self.system = System(settings or Settings())
        self.scene: SceneConfig | None = None
        self.objects: list[SceneObject] = []
        self.objects_map: dict[str, SceneObject] = {}
        self.run_realtime = False

    # -------------------------------------------------------------- load

    def load(self, config_file: str):
        cfg = parse_scene_file(config_file)
        self.scene = cfg
        s = self.system.settings
        s.admm_iters = cfg.solver.iterations
        s.timestep_s = cfg.solver.timestep
        s.verbose = cfg.solver.verbose
        self.run_realtime = cfg.solver.realtime

        for obj in cfg.objects:
            mesh = _build_geometry(obj, cfg.base_dir)
            mesh.apply_xform(compose_xform(obj))
            is_tet = isinstance(mesh, TetMesh)
            faces = mesh.need_surface() if is_tet else mesh.faces
            so = SceneObject(component=obj, mesh=mesh, faces=np.asarray(faces))
            force_params = obj.get_all("force")
            if force_params:
                self._add_dynamic(so, obj, force_params, cfg)
            self.objects.append(so)
            if obj.name:
                self.objects_map[obj.name] = so
        return self

    def _add_dynamic(self, so: SceneObject, obj: Component, force_params, cfg):
        mesh = so.mesh
        n_verts = len(mesh.vertices)
        if not obj.exists("mass"):
            raise ValueError(
                f"**Error: You must specify mass (kg) for object {obj.name!r}"
            )
        obj_mass = obj.get("mass").as_double()
        density_weighted = True
        if obj.exists("density_weighted_mass"):
            density_weighted = obj.get("density_weighted_mass").as_bool()

        if density_weighted:
            if isinstance(mesh, TetMesh):
                masses = lump_masses_tets(mesh.vertices, mesh.tets, obj_mass)
            else:
                masses = lump_masses_tris(mesh.vertices, mesh.faces, obj_mass)
        else:
            masses = lump_masses_uniform(n_verts, obj_mass)

        so.index_offset = self.system.n_nodes
        so.n_nodes = n_verts
        self.system.add_nodes(np.asarray(mesh.vertices), masses)

        for fp in force_params:
            fname = fp.as_str()
            if fname not in cfg.forces:
                raise ValueError(
                    f"**ForceBuilder::Error: No force named {fname!r} for object "
                    f"{obj.name!r}"
                )
            for batch in _make_constraints(
                mesh, so.faces, cfg.forces[fname], so.index_offset,
            ):
                self.system.add_force(batch)

    # -------------------------------------------------------- initialize

    def initialize(self):
        """Instantiate global forces from the force definitions (gravity,
        wind, static anchors; SimContext.cpp:105-173) then build the system."""
        cfg = self.scene
        if cfg is not None:
            for name, f in cfg.forces.items():
                ft = f.type.lower()
                if ft == "explicitforce":
                    d = f.get("direction").as_vec3() if f.exists("direction") else np.zeros(3)
                    self.system.add_explicit_force(ExplicitForce(direction=d))
                elif ft == "staticanchor":
                    self.system.add_force(StaticAnchor([f.get("index").as_int()]))
                elif ft in ("windforce", "wind"):
                    faces, offsets = [], []
                    for so in self.objects:
                        if so.is_dynamic and len(so.faces):
                            faces.append(so.faces + so.index_offset)
                    if faces:
                        d = f.get("direction").as_vec3() if f.exists("direction") else np.zeros(3)
                        self.system.add_explicit_force(
                            WindForce(np.concatenate(faces), direction=d)
                        )
        if not self.system.initialize():
            raise RuntimeError("system initialize failed")
        return self

    # ------------------------------------------------------------- step

    def step(self, screen_dt: float | None = None) -> bool:
        """One step, or enough steps to cover screen_dt when realtime
        (SimContext.cpp:198-210)."""
        if not self.run_realtime or screen_dt is None:
            return self.system.step()
        timeleft = float(screen_dt)
        while timeleft > 0.0:
            if not self.system.step():
                return False
            timeleft -= self.system.settings.timestep_s
        return True

    def update(self):
        """Copy system positions back into per-object host meshes
        (SimContext.cpp:176-195)."""
        x = self.system.x
        for so in self.objects:
            if so.is_dynamic:
                so.mesh.vertices = x[so.index_offset : so.index_offset + so.n_nodes]
        return True

    # ------------------------------------------------------------ export

    def make_object(self, type_: str, name: str = "", **params) -> SceneObject:
        """Programmatic object creation (SceneManager::make_object analog,
        SceneManager.cpp:236-262). params are XML-style strings or values,
        e.g. make_object('sphere', tess=16, radius=0.5, translate='0 1 0').
        Static (no-Force) objects only — dynamic objects need the full
        load() path for mass/force bookkeeping."""
        comp = Component(kind="object", name=name, type=type_)
        for tag, value in params.items():
            comp.params.append(
                Param(tag=tag.lower(), value=" ".join(str(v) for v in np.atleast_1d(value)))
            )
        mesh = _build_geometry(comp, self.scene.base_dir if self.scene else ".")
        mesh.apply_xform(compose_xform(comp))
        is_tet = isinstance(mesh, TetMesh)
        faces = mesh.need_surface() if is_tet else mesh.faces
        so = SceneObject(component=comp, mesh=mesh, faces=np.asarray(faces))
        self.objects.append(so)
        if name:
            self.objects_map[name] = so
        return so

    def make_light(self, type_: str = "point", name: str = "", **params) -> Component:
        """Programmatic light creation (SceneManager::make_light analog).
        Lights are retained for scene export; no GL renderer consumes them."""
        comp = Component(kind="light", name=name, type=type_)
        for tag, value in params.items():
            comp.params.append(
                Param(tag=tag.lower(), value=" ".join(str(v) for v in np.atleast_1d(value)))
            )
        if self.scene is not None:
            self.scene.lights.append(comp)
        return comp

    def make_3pt_lighting(self, center=(0.0, 0.0, 0.0), distance=1.0):
        """Key/fill/rim point lights around the scene
        (SceneManager::make_3pt_lighting, SceneManager.cpp:295-327)."""
        c = np.asarray(center, dtype=float)
        if self.scene is not None:
            self.scene.lights = [l for l in self.scene.lights if l.name[:6] != "_3pt_"]
        out = []
        for name, off, inten in [
            ("_3pt_key", (-distance, distance * 0.5, distance), 0.8),
            ("_3pt_fill", (distance, distance * 0.25, distance), 0.4),
            ("_3pt_rim", (0.0, distance * 0.5, -distance), 0.6),
        ]:
            p = c + np.asarray(off)
            out.append(
                self.make_light(
                    "point", name=name,
                    position=f"{p[0]} {p[1]} {p[2]}",
                    intensity=f"{inten} {inten} {inten}",
                    falloff="1 0 0",
                )
            )
        return out

    def radius(self) -> float:
        """Bounding-sphere radius of all scene geometry
        (SceneManager::radius analog, SceneManager.cpp:330-346)."""
        pts = np.concatenate([np.asarray(o.vertices) for o in self.objects])
        c = 0.5 * (pts.min(axis=0) + pts.max(axis=0))
        return float(np.linalg.norm(pts - c, axis=1).max())

    def save_scene(self, path: str):
        """Write the current scene back out in the XML dialect
        (SceneManager::save analog, SceneManager.cpp:156-209). Object
        geometry is exported to sidecar files next to the XML."""
        import xml.sax.saxutils as sx

        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        base = os.path.splitext(path)[0]
        lines = ['<?xml version="1.0"?>', "<mclScene>"]
        self.update()
        for i, so in enumerate(self.objects):
            name = so.component.name or f"obj{i}"
            mesh = so.mesh
            if isinstance(mesh, TetMesh):
                prefix = f"{base}_{name}"
                mesh.save(prefix)
                lines.append(f'\t<Object name="{sx.escape(name)}" type="tetmesh" >')
                lines.append(f'\t\t<File value="{os.path.basename(prefix)}" />')
            else:
                obj_path = f"{base}_{name}.obj"
                TriMesh(np.asarray(mesh.vertices), np.asarray(so.faces)).save_obj(
                    obj_path
                )
                lines.append(f'\t<Object name="{sx.escape(name)}" type="trimesh" >')
                lines.append(
                    f'\t\t<File value="{os.path.basename(obj_path)}" />'
                )
            for p in so.component.params:
                if p.tag in ("force", "mass", "material", "density_weighted_mass"):
                    lines.append(
                        f'\t\t<{p.tag} value="{sx.escape(p.value)}" />'
                    )
            lines.append("\t</Object>")
        lines.append("</mclScene>")
        lines.append("<admmelastic>")
        if self.scene is not None:
            for fname, f in self.scene.forces.items():
                lines.append(
                    f'\t<Force name="{sx.escape(fname)}" type="{sx.escape(f.type)}" >'
                )
                for p in f.params:
                    lines.append(f'\t\t<{p.tag} value="{sx.escape(p.value)}" />')
                lines.append("\t</Force>")
        s = self.system.settings
        lines += [
            "\t<solver>",
            f'\t\t<iterations value="{s.admm_iters}" />',
            f'\t\t<timestep value="{s.timestep_s}" />',
            f'\t\t<realtime value="{int(self.run_realtime)}" />',
            "\t</solver>",
            "</admmelastic>",
            "",
        ]
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return path

    def export_obj(self, directory: str, frame: int):
        """Write every object's current surface to OBJ (offline viz in place
        of the reference's GL renderer)."""
        os.makedirs(directory, exist_ok=True)
        self.update()
        for i, so in enumerate(self.objects):
            name = so.component.name or f"obj{i}"
            path = os.path.join(directory, f"{name}_{frame:05d}.obj")
            TriMesh(np.asarray(so.vertices), np.asarray(so.faces)).save_obj(path)

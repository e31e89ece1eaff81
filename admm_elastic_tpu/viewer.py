"""Self-contained interactive HTML viewer for simulation rollouts.

The reference renders interactively through GLFW/OpenGL
(deps/mclscene/src/Application.cpp:69-172: orbit/zoom camera, SPACE
run/pause, P single-step) — a windowed GUI this container cannot open.
The JAX-framework analog exports the rollout as ONE dependency-free HTML
file with an embedded WebGL2 renderer: drag = orbit, wheel = zoom,
SPACE = play/pause, ←/→ = single-step, slider = scrub. Flat shading
comes from fragment-shader derivatives (no normals are stored), so the
payload is just quantized per-frame vertex positions + one index buffer
per object.

Per-frame positions are uint16-quantized against the whole-animation
bounding box (~6 significant digits over typical scene extents) and
base64-embedded, so a 100-frame cloth rollout is ~1 MB and opens from
file:// with zero network access.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>admm_elastic_tpu viewer</title>
<style>
  html,body{margin:0;height:100%;background:#1b1e23;color:#cfd3da;
    font:13px system-ui,sans-serif;overflow:hidden}
  #c{display:block;width:100%;height:calc(100% - 42px)}
  #bar{height:42px;display:flex;align-items:center;gap:10px;padding:0 12px;
    box-sizing:border-box;background:#14161a}
  #play{width:64px}
  #frame{flex:1}
  button{background:#2a2f37;color:#cfd3da;border:1px solid #3a404a;
    border-radius:4px;padding:4px 10px;cursor:pointer}
</style></head><body>
<canvas id="c"></canvas>
<div id="bar">
  <button id="play">Play</button>
  <input id="frame" type="range" min="0" value="0" step="1">
  <span id="label"></span>
</div>
<script>
"use strict";
const META = __META__;
const PAYLOAD = "__PAYLOAD__";

// ---- decode payload ------------------------------------------------------
const bin = Uint8Array.from(atob(PAYLOAD), ch => ch.charCodeAt(0));
const u16 = new Uint16Array(bin.buffer, 0, bin.byteLength >> 1);
const [bx, by, bz] = META.bbox_min, [sx, sy, sz] = META.bbox_scale;
const F = META.n_frames;
// objects: {name, nv, offset (u16 elements per frame), faces (flat idx),
//           color}
let frameStride = 0;
for (const o of META.objects) frameStride += o.nv * 3;
function framePositions(obj, f) {
  const out = new Float32Array(obj.nv * 3);
  let p = f * frameStride + obj.offset;
  for (let i = 0; i < obj.nv; i++) {
    out[3*i]   = bx + sx * u16[p++];
    out[3*i+1] = by + sy * u16[p++];
    out[3*i+2] = bz + sz * u16[p++];
  }
  return out;
}

// ---- webgl ---------------------------------------------------------------
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl2", {antialias: true});
if (!gl) {
  document.body.textContent = "WebGL2 required";
  throw new Error("WebGL2 required");
}
const VS = `#version 300 es
layout(location=0) in vec3 pos;
uniform mat4 mvp, mv;
out vec3 vpos;
void main(){ vpos = (mv * vec4(pos,1.0)).xyz;
  gl_Position = mvp * vec4(pos,1.0); }`;
const FS = `#version 300 es
precision highp float;
in vec3 vpos; uniform vec3 color; out vec4 frag;
void main(){
  vec3 n = normalize(cross(dFdx(vpos), dFdy(vpos)));
  float d = abs(n.z);                       // headlight diffuse
  vec3 l = normalize(vec3(0.4, 0.7, 0.58));
  float d2 = max(dot(n, l), 0.0);
  vec3 c = color * (0.22 + 0.48 * d + 0.42 * d2);
  frag = vec4(pow(c, vec3(1.0/2.2)), 1.0); }`;
function shader(type, src) {
  const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s);
  if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, shader(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, shader(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const uMVP = gl.getUniformLocation(prog, "mvp");
const uMV = gl.getUniformLocation(prog, "mv");
const uColor = gl.getUniformLocation(prog, "color");
gl.enable(gl.DEPTH_TEST);

const draws = META.objects.map(o => {
  const vbo = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, vbo);
  gl.bufferData(gl.ARRAY_BUFFER, o.nv * 12, gl.DYNAMIC_DRAW);
  const ibo = gl.createBuffer();
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ibo);
  gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, new Uint32Array(o.faces),
                gl.STATIC_DRAW);
  return {o, vbo, ibo, n: o.faces.length};
});

// ---- camera (orbit) ------------------------------------------------------
const center = META.center;
let theta = 0.5, phi = 0.35, dist = META.radius * 2.6;
function mat(colmajor){ return new Float32Array(colmajor); }
function persp(fov, asp, near, far) {
  const f = 1 / Math.tan(fov / 2), nf = 1 / (near - far);
  return mat([f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1,
              0,0,2*far*near*nf,0]);
}
function mul(a, b) {   // column-major 4x4
  const o = new Float32Array(16);
  for (let c = 0; c < 4; c++) for (let r = 0; r < 4; r++) {
    let s = 0;
    for (let k = 0; k < 4; k++) s += a[k*4+r] * b[c*4+k];
    o[c*4+r] = s;
  }
  return o;
}
function lookAtMV() {
  const cx = center[0] + dist * Math.cos(phi) * Math.sin(theta);
  const cy = center[1] + dist * Math.sin(phi);
  const cz = center[2] + dist * Math.cos(phi) * Math.cos(theta);
  const eye = [cx, cy, cz];
  let f = [center[0]-cx, center[1]-cy, center[2]-cz];
  const fl = Math.hypot(...f); f = f.map(v => v/fl);
  let up = [0,1,0];
  let s = [f[1]*up[2]-f[2]*up[1], f[2]*up[0]-f[0]*up[2],
           f[0]*up[1]-f[1]*up[0]];
  const sl = Math.hypot(...s); s = s.map(v => v/sl);
  const u = [s[1]*f[2]-s[2]*f[1], s[2]*f[0]-s[0]*f[2],
             s[0]*f[1]-s[1]*f[0]];
  return mat([s[0],u[0],-f[0],0, s[1],u[1],-f[1],0, s[2],u[2],-f[2],0,
    -(s[0]*eye[0]+s[1]*eye[1]+s[2]*eye[2]),
    -(u[0]*eye[0]+u[1]*eye[1]+u[2]*eye[2]),
    f[0]*eye[0]+f[1]*eye[1]+f[2]*eye[2], 1]);
}

// ---- playback ------------------------------------------------------------
let frame = 0, playing = false, lastT = 0;
const slider = document.getElementById("frame");
slider.max = F - 1;
const label = document.getElementById("label");
const playBtn = document.getElementById("play");
window.viewerState = {frame: 0, playing: false, frames: F,
                      objects: META.objects.length};

function upload(f) {
  for (const d of draws) {
    gl.bindBuffer(gl.ARRAY_BUFFER, d.vbo);
    gl.bufferData(gl.ARRAY_BUFFER, framePositions(d.o, f),
                  gl.DYNAMIC_DRAW);
  }
}
function draw() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) {
    canvas.width = w; canvas.height = h;
  }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.106, 0.118, 0.137, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  const mv = lookAtMV();
  const mvp = mul(persp(0.9, w / Math.max(h,1), META.radius*0.01,
                        META.radius*40), mv);
  gl.uniformMatrix4fv(uMV, false, mv);
  gl.uniformMatrix4fv(uMVP, false, mvp);
  for (const d of draws) {
    gl.uniform3fv(uColor, d.o.color);
    gl.bindBuffer(gl.ARRAY_BUFFER, d.vbo);
    gl.enableVertexAttribArray(0);
    gl.vertexAttribPointer(0, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, d.ibo);
    gl.drawElements(gl.TRIANGLES, d.n, gl.UNSIGNED_INT, 0);
  }
  label.textContent = `frame ${frame + 1}/${F}`;
  slider.value = frame;
  window.viewerState.frame = frame;
  window.viewerState.playing = playing;
}
function setFrame(f) {
  frame = Math.max(0, Math.min(F - 1, f));
  upload(frame); draw();
}
function tick(t) {
  if (playing && t - lastT > 1000 / META.fps) {
    lastT = t; setFrame((frame + 1) % F);
  }
  requestAnimationFrame(tick);
}
function setPlaying(p) {
  playing = p; playBtn.textContent = p ? "Pause" : "Play";
  window.viewerState.playing = p;
}
playBtn.onclick = () => setPlaying(!playing);
slider.oninput = () => { setPlaying(false); setFrame(+slider.value); };
window.addEventListener("keydown", e => {
  if (e.code === "Space") { e.preventDefault(); setPlaying(!playing); }
  if (e.code === "ArrowRight") { setPlaying(false); setFrame(frame + 1); }
  if (e.code === "ArrowLeft") { setPlaying(false); setFrame(frame - 1); }
});
let dragging = false, px = 0, py = 0;
canvas.onmousedown = e => { dragging = true; px = e.clientX; py = e.clientY; };
window.onmouseup = () => dragging = false;
window.onmousemove = e => {
  if (!dragging) return;
  theta -= (e.clientX - px) * 0.008;
  phi = Math.max(-1.5, Math.min(1.5, phi + (e.clientY - py) * 0.008));
  px = e.clientX; py = e.clientY; draw();
};
canvas.onwheel = e => {
  e.preventDefault();
  dist *= Math.exp(e.deltaY * 0.001);
  dist = Math.max(META.radius * 0.2, Math.min(META.radius * 30, dist));
  draw();
};
window.onresize = draw;
setFrame(0);
requestAnimationFrame(tick);
</script></body></html>
"""

_PALETTE = (
    (0.42, 0.62, 0.87), (0.87, 0.56, 0.35), (0.55, 0.78, 0.47),
    (0.80, 0.47, 0.66), (0.72, 0.70, 0.44), (0.50, 0.74, 0.74),
)


def export_html_viewer(frames, faces, path, *, names=None, colors=None,
                       fps=30):
    """Write a self-contained interactive HTML viewer.

    frames: list over time of lists over objects of (nv,3) float arrays
    faces:  list over objects of (nf,3) int arrays (triangles)
    colors: optional list of RGB triples in [0,1] per object
    """
    if not frames:
        raise ValueError("no frames")
    n_obj = len(faces)
    if any(len(fr) != n_obj for fr in frames):
        raise ValueError("every frame must carry every object")
    all_pts = np.concatenate(
        [np.asarray(p, np.float64).reshape(-1, 3) for fr in frames
         for p in fr], axis=0)
    lo = all_pts.min(axis=0)
    hi = all_pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    scale = span / 65535.0

    objects = []
    offset = 0
    for oi in range(n_obj):
        nv = int(np.asarray(frames[0][oi]).shape[0])
        f = np.asarray(faces[oi], np.int64).reshape(-1, 3)
        col = (list(colors[oi]) if colors is not None and colors[oi]
               is not None else list(_PALETTE[oi % len(_PALETTE)]))
        objects.append({
            "name": (names[oi] if names else f"object{oi}"),
            "nv": nv,
            "offset": offset,
            "faces": f.reshape(-1).tolist(),
            "color": [float(c) for c in col],
        })
        offset += nv * 3

    payload = np.empty((len(frames), offset), np.uint16)
    for fi, fr in enumerate(frames):
        cur = 0
        for oi in range(n_obj):
            p = np.asarray(fr[oi], np.float64).reshape(-1, 3)
            q = np.clip(np.rint((p - lo) / scale), 0, 65535).astype(
                np.uint16)
            payload[fi, cur:cur + q.size] = q.reshape(-1)
            cur += q.size
    meta = {
        "n_frames": len(frames),
        "fps": float(fps),
        "bbox_min": [float(v) for v in lo],
        "bbox_scale": [float(v) for v in scale],
        "center": [float(v) for v in (lo + hi) / 2.0],
        "radius": float(np.linalg.norm(hi - lo) / 2.0) or 1.0,
        "objects": objects,
    }
    html = _HTML.replace("__META__", json.dumps(meta)).replace(
        "__PAYLOAD__",
        base64.b64encode(payload.tobytes()).decode("ascii"),
    )
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(html)
    return path


def record_html_viewer(ctx, path, n_frames, steps_per_frame=1, fps=30):
    """Step a SimContext, recording every object's surface each frame,
    and export the interactive viewer (Application::display's
    step-update-draw loop, Application.cpp:116-168, recorded instead of
    windowed). Uses scene material diffuse colors when declared."""
    from .viz import object_material

    faces = [np.asarray(o.faces) for o in ctx.objects]
    names = []
    colors = []
    for o in ctx.objects:
        try:
            names.append(o.component.name)
        except Exception:
            names.append(None)
        diffuse = object_material(ctx.scene, o).get("diffuse")
        colors.append(None if diffuse is None
                      else [float(v) for v in diffuse])
    frames = []
    for _ in range(n_frames):
        for _ in range(steps_per_frame):
            ctx.step()
        ctx.update()
        frames.append([np.array(o.vertices, np.float64) for o in
                       ctx.objects])
    return export_html_viewer(frames, faces, path, names=names,
                              colors=colors, fps=fps)

"""Standalone interactive HTML viewer, the live-rviz replacement (port of
``icpslam_tpu/viz/html.py``).

One self-contained HTML file (inline WebGL, no network, no external
script) with the map cloud coloured by height, the trajectory and the
ground truth as polylines, and the pose graph: nodes on the reference's
id-proportional colour ramp, sequential and loop edges split by the
|i − j| > 2 rule; orbit, pan and zoom, a toggle per layer, a stats bar.
The layers are the JAX viewer's, encoded alike (float32 little-endian,
base64), so the same inputs decode to the same arrays; the page is the
same template.

Entry points: ``export_html`` (explicit layers) and ``export_state_html``
(everything from a ``SlamState``). Inputs are the port's tensors (any
device) or numpy arrays.
"""

from __future__ import annotations

import base64
import json
from typing import Optional, Sequence

import numpy as np

from icpslam_tpu_torch.geometry.se3 import Pose
from icpslam_tpu_torch.viz.export import host


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a, dtype="<f4").tobytes()).decode()


def _ramp_colors(n: int) -> np.ndarray:
    """Id-proportional node colours: blue → cyan → yellow → red."""
    t = np.linspace(0.0, 1.0, max(n, 1), dtype=np.float32)
    r = np.clip(2.0 * t - 0.5, 0.0, 1.0)
    g = np.clip(1.5 - np.abs(2.0 * t - 1.0) * 1.5, 0.0, 1.0)
    b = np.clip(1.0 - 2.0 * t, 0.0, 1.0)
    return np.stack([r, g, b], axis=-1)


def points_layer(
    name: str,
    points: np.ndarray,
    *,
    colors: Optional[np.ndarray] = None,
    color: Sequence[float] = (0.8, 0.8, 0.8),
    color_mode: str = "flat",
    point_size: float = 2.0,
    visible: bool = True,
) -> dict:
    """A points layer; ``color_mode`` is 'flat', 'height' or 'rgb'."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    layer = {
        "name": name,
        "kind": "points",
        "pos": _b64(pts),
        "n": int(pts.shape[0]),
        "colorMode": color_mode,
        "color": list(map(float, color)),
        "pointSize": float(point_size),
        "visible": bool(visible),
    }
    if colors is not None:
        layer["colors"] = _b64(np.asarray(colors, np.float32).reshape(-1, 3))
        layer["colorMode"] = "rgb"
    return layer


def line_layer(
    name: str,
    points: np.ndarray,
    *,
    strip: bool = True,
    color: Sequence[float] = (0.2, 0.9, 1.0),
    visible: bool = True,
) -> dict:
    """A polyline (``strip=True``) or a list of segment pairs."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    return {
        "name": name,
        "kind": "linestrip" if strip else "lines",
        "pos": _b64(pts),
        "n": int(pts.shape[0]),
        "colorMode": "flat",
        "color": list(map(float, color)),
        "visible": bool(visible),
    }


# the reference's marker colours (icpslam.yaml): left at these, the
# viewer keeps its own styling (the id ramp)
_REF_NODE_COLOR = (0.0, 1.0, 0.0, 1.0)
_REF_ODOM_COLOR = (0.0, 0.5, 0.5, 1.0)
_REF_EDGE_COLOR = (0.0, 0.0, 1.0, 1.0)


def graph_layers(state, config=None) -> list:
    """The pose graph's layers: ramped nodes, sequential and loop edge
    segments. ``config`` applies the reference's marker keys: node size
    and edge width scale with ``marker_scale_nodes`` / ``marker_scale_edges``,
    a colour set away from the reference's default replaces the viewer's
    (one edge colour for both edge kinds, as the reference has), and
    ``odom_nodes_markers_color`` adds the odometry-frame node layer."""
    store = state.keyframes
    n = int(store.count)
    layers = []
    if n == 0:
        return layers
    node_size = 8.0
    edge_width = 1.0
    node_flat = None
    seq_color = (0.55, 0.55, 0.6)
    loop_color = (1.0, 0.25, 0.25)
    odom_color = None
    if config is not None:
        node_size = 8.0 * float(config.marker_scale_nodes) / 0.1
        edge_width = max(1.0, float(config.marker_scale_edges) / 0.05)
        if tuple(config.icp_nodes_markers_color) != _REF_NODE_COLOR:
            node_flat = tuple(config.icp_nodes_markers_color)[:3]
        if tuple(config.edges_markers_color) != _REF_EDGE_COLOR:
            seq_color = tuple(config.edges_markers_color)[:3]
            loop_color = seq_color
        if tuple(config.odom_nodes_markers_color) != _REF_ODOM_COLOR:
            odom_color = tuple(config.odom_nodes_markers_color)[:3]
    t = host(store.pose_graph.t)[:n]
    if node_flat is not None:
        layers.append(points_layer("graph nodes", t, color=node_flat, color_mode="flat",
                                   point_size=node_size))
    else:
        layers.append(points_layer("graph nodes", t, colors=_ramp_colors(n),
                                   point_size=node_size))
    if odom_color is not None:
        t_odom = host(store.pose_odom.t)[:n]
        layers.append(points_layer("odom nodes", t_odom, color=odom_color, color_mode="flat",
                                   point_size=node_size * 0.75))
    ecount = int(state.edges.count)
    if ecount:
        ei = host(state.edges.i)[:ecount]
        ej = host(state.edges.j)[:ecount]
        valid = host(state.edges.valid)[:ecount]
        seq, loop = [], []
        for k in range(ecount):
            if not valid[k] or ei[k] >= n or ej[k] >= n:
                continue
            seg = (t[int(ei[k])], t[int(ej[k])])
            (loop if abs(int(ej[k]) - int(ei[k])) > 2 else seq).extend(seg)
        for name, segs, color in (("sequential edges", seq, seq_color),
                                  ("loop edges", loop, loop_color)):
            if segs:
                lay = line_layer(name, np.asarray(segs), strip=False, color=color)
                lay["width"] = edge_width
                layers.append(lay)
    return layers


def export_html(
    path: str,
    layers: Sequence[dict],
    *,
    title: str = "icpslam_tpu_torch",
    stats: Optional[dict] = None,
) -> str:
    """Write the viewer with the given layers. Returns ``path``."""
    doc = {"title": title, "layers": list(layers), "stats": stats or {}}
    html = _TEMPLATE.replace("/*__DATA__*/null", json.dumps(doc))
    with open(path, "w") as f:
        f.write(html)
    return path


def map_points(map_) -> np.ndarray:
    """The live points of a point or voxel map, (n, 3)."""
    pts = host(map_.points)
    return pts[: int(map_.size)]


def export_state_html(
    path: str,
    state,
    *,
    trajectory: Optional[Pose] = None,
    ground_truth: Optional[Pose] = None,
    title: str = "icpslam_tpu_torch",
    max_map_points: int = 500_000,
    config=None,
) -> str:
    """The viewer of a run: map, trajectories and pose graph. Above
    ``max_map_points`` the map is subsampled with ``RandomState(0)``, as
    in JAX."""
    layers = []
    pts = map_points(state.map)
    if pts.shape[0] > max_map_points:
        pts = pts[np.random.RandomState(0).choice(pts.shape[0], max_map_points, replace=False)]
    if pts.shape[0]:
        layers.append(points_layer("map", pts, color_mode="height", point_size=2.0))
    if trajectory is not None and trajectory.t.shape[0]:
        layers.append(line_layer("trajectory", host(trajectory.t), color=(0.2, 0.9, 1.0)))
    if ground_truth is not None and ground_truth.t.shape[0]:
        layers.append(line_layer("ground truth", host(ground_truth.t), color=(0.3, 1.0, 0.4)))
    layers.extend(graph_layers(state, config=config))
    stats = {
        "keyframes": int(state.keyframes.count),
        "map points": int(state.map.size),
        "loop closures": int(state.num_loop_closures),
        "optimizations": int(state.num_optimizations),
    }
    return export_html(path, layers, title=title, stats=stats)


_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>icpslam_tpu viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#101216;
   font:12px/1.5 system-ui,sans-serif;color:#cfd4dc}
 #c{width:100%;height:100%;display:block;cursor:grab}
 #hud{position:fixed;top:10px;left:10px;background:rgba(16,18,22,.85);
   border:1px solid #2a2e36;border-radius:8px;padding:10px 12px;user-select:none}
 #hud h1{font-size:13px;margin:0 0 6px;color:#fff;font-weight:600}
 #hud label{display:block;cursor:pointer;white-space:nowrap}
 #hud .sw{display:inline-block;width:10px;height:10px;border-radius:2px;
   margin-right:6px;vertical-align:-1px}
 #stats{position:fixed;bottom:10px;left:10px;background:rgba(16,18,22,.85);
   border:1px solid #2a2e36;border-radius:8px;padding:6px 12px}
 #help{position:fixed;bottom:10px;right:10px;color:#6b7280}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><h1 id="title"></h1><div id="layers"></div></div>
<div id="stats"></div>
<div id="help">drag orbit · shift/right-drag pan · wheel zoom · dblclick reset</div>
<script>
"use strict";
const DATA = /*__DATA__*/null;

function f32(b64){const s=atob(b64);const u=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new Float32Array(u.buffer);}

// ---- tiny mat4 ----
function persp(fov,asp,near,far){const f=1/Math.tan(fov/2),o=new Float32Array(16);
  o[0]=f/asp;o[5]=f;o[10]=(far+near)/(near-far);o[11]=-1;o[14]=2*far*near/(near-far);return o;}
function lookAt(eye,ctr,up){
  let z=[eye[0]-ctr[0],eye[1]-ctr[1],eye[2]-ctr[2]];
  let zl=Math.hypot(...z);z=z.map(v=>v/zl);
  let x=[up[1]*z[2]-up[2]*z[1],up[2]*z[0]-up[0]*z[2],up[0]*z[1]-up[1]*z[0]];
  let xl=Math.hypot(...x)||1;x=x.map(v=>v/xl);
  const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
  return new Float32Array([x[0],y[0],z[0],0,x[1],y[1],z[1],0,x[2],y[2],z[2],0,
    -(x[0]*eye[0]+x[1]*eye[1]+x[2]*eye[2]),
    -(y[0]*eye[0]+y[1]*eye[1]+y[2]*eye[2]),
    -(z[0]*eye[0]+z[1]*eye[1]+z[2]*eye[2]),1]);}
function mul(a,b){const o=new Float32Array(16);
  for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;
    for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}return o;}

// ---- GL setup ----
const canvas=document.getElementById("c");
const gl=canvas.getContext("webgl",{antialias:true});
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;uniform float ps;
 varying vec3 vc;uniform int mode;uniform vec3 flat_c;uniform vec2 zr;
 vec3 ramp(float t){t=clamp(t,0.,1.);
  return vec3(clamp(2.*t-.5,0.,1.),clamp(1.5-abs(2.*t-1.)*1.5,0.,1.),clamp(1.-2.*t,0.,1.));}
 void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;
  if(mode==0)vc=flat_c;else if(mode==1)vc=ramp((p.z-zr.x)/max(zr.y-zr.x,1e-6));else vc=col;}`;
const FS=`precision mediump float;varying vec3 vc;uniform int round_pt;
 void main(){if(round_pt==1){vec2 d=gl_PointCoord-vec2(.5);
   if(dot(d,d)>.25)discard;}gl_FragColor=vec4(vc,1.);}`;
function shader(type,src){const s=gl.createShader(type);gl.shaderSource(s,src);
  gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
  throw gl.getShaderInfoLog(s);return s;}
const prog=gl.createProgram();
gl.attachShader(prog,shader(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,shader(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const loc={p:gl.getAttribLocation(prog,"p"),col:gl.getAttribLocation(prog,"col"),
  mvp:gl.getUniformLocation(prog,"mvp"),ps:gl.getUniformLocation(prog,"ps"),
  mode:gl.getUniformLocation(prog,"mode"),flat_c:gl.getUniformLocation(prog,"flat_c"),
  zr:gl.getUniformLocation(prog,"zr"),round_pt:gl.getUniformLocation(prog,"round_pt")};

// ---- layers ----
let lo=[1e30,1e30,1e30],hi=[-1e30,-1e30,-1e30];
const layers=DATA.layers.map(L=>{
  const pos=f32(L.pos);
  for(let i=0;i<pos.length;i+=3)for(let a=0;a<3;a++){
    const v=pos[i+a];if(v<lo[a])lo[a]=v;if(v>hi[a])hi[a]=v;}
  const buf=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,buf);
  gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
  let cbuf=null;
  if(L.colors){cbuf=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,cbuf);
    gl.bufferData(gl.ARRAY_BUFFER,f32(L.colors),gl.STATIC_DRAW);}
  return{...L,buf,cbuf,on:L.visible!==false};});
if(lo[0]>hi[0]){lo=[-1,-1,-1];hi=[1,1,1];}
const ctr0=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
const span=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2],1e-3);

// ---- camera state (z-up orbit) ----
let cam;
function resetCam(){cam={yaw:-0.7,pitch:0.5,dist:span*1.6,
  ctr:ctr0.slice()};}
resetCam();

function draw(){
  const w=canvas.clientWidth,h=canvas.clientHeight;
  if(canvas.width!==w*devicePixelRatio||canvas.height!==h*devicePixelRatio){
    canvas.width=w*devicePixelRatio;canvas.height=h*devicePixelRatio;}
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.063,0.071,0.086,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  const cp=Math.cos(cam.pitch),sp=Math.sin(cam.pitch);
  const eye=[cam.ctr[0]+cam.dist*cp*Math.cos(cam.yaw),
             cam.ctr[1]+cam.dist*cp*Math.sin(cam.yaw),
             cam.ctr[2]+cam.dist*sp];
  const mvp=mul(persp(0.9,w/h,span*0.002,span*40),lookAt(eye,cam.ctr,[0,0,1]));
  gl.uniformMatrix4fv(loc.mvp,false,mvp);
  gl.uniform2f(loc.zr,lo[2],hi[2]);
  for(const L of layers){
    if(!L.on||!L.n)continue;
    gl.bindBuffer(gl.ARRAY_BUFFER,L.buf);
    gl.enableVertexAttribArray(loc.p);
    gl.vertexAttribPointer(loc.p,3,gl.FLOAT,false,0,0);
    if(L.cbuf){gl.bindBuffer(gl.ARRAY_BUFFER,L.cbuf);
      gl.enableVertexAttribArray(loc.col);
      gl.vertexAttribPointer(loc.col,3,gl.FLOAT,false,0,0);
      gl.uniform1i(loc.mode,2);}
    else{gl.disableVertexAttribArray(loc.col);
      gl.vertexAttrib3f(loc.col,1,1,1);
      gl.uniform1i(loc.mode,L.colorMode==="height"?1:0);
      gl.uniform3fv(loc.flat_c,L.color);}
    gl.uniform1f(loc.ps,(L.pointSize||2)*devicePixelRatio);
    gl.uniform1i(loc.round_pt,L.kind==="points"&&(L.pointSize||2)>4?1:0);
    if(L.kind!=="points"){gl.lineWidth(L.width||1);}
    gl.drawArrays(L.kind==="points"?gl.POINTS:
      L.kind==="lines"?gl.LINES:gl.LINE_STRIP,0,L.n);
  }
}
function frame(){draw();requestAnimationFrame(frame);}

// ---- interaction ----
let drag=null;
canvas.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,
  pan:e.button===2||e.shiftKey};canvas.style.cursor="grabbing";});
window.addEventListener("mouseup",()=>{drag=null;canvas.style.cursor="grab";});
window.addEventListener("mousemove",e=>{
  if(!drag)return;const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
  drag.x=e.clientX;drag.y=e.clientY;
  if(drag.pan){const s=cam.dist*0.0015;
    const cy=Math.cos(cam.yaw),sy=Math.sin(cam.yaw);
    // screen-right = (-sin yaw, cos yaw), screen-up ≈ world z (tilted)
    cam.ctr[0]+=s*(dx*sy);cam.ctr[1]+=s*(-dx*cy);cam.ctr[2]+=s*dy;}
  else{cam.yaw-=dx*0.008;
    cam.pitch=Math.min(1.55,Math.max(-1.55,cam.pitch+dy*0.008));}});
canvas.addEventListener("wheel",e=>{e.preventDefault();
  cam.dist*=Math.exp(e.deltaY*0.0012);
  cam.dist=Math.min(span*30,Math.max(span*0.01,cam.dist));},{passive:false});
canvas.addEventListener("contextmenu",e=>e.preventDefault());
canvas.addEventListener("dblclick",resetCam);

// ---- HUD ----
document.getElementById("title").textContent=DATA.title;
document.title=DATA.title;
const lyDiv=document.getElementById("layers");
layers.forEach(L=>{
  const lab=document.createElement("label");
  const cb=document.createElement("input");cb.type="checkbox";cb.checked=L.on;
  cb.onchange=()=>{L.on=cb.checked;};
  const sw=document.createElement("span");sw.className="sw";
  const c=L.colorMode==="height"?[0.9,0.7,0.2]:L.color;
  sw.style.background=L.cbuf?"linear-gradient(90deg,#22f,#f22)":
    `rgb(${c.map(v=>Math.round(v*255)).join(",")})`;
  lab.appendChild(cb);lab.appendChild(sw);
  lab.appendChild(document.createTextNode(`${L.name} (${L.n})`));
  lyDiv.appendChild(lab);});
document.getElementById("stats").textContent=
  Object.entries(DATA.stats).map(([k,v])=>`${k}: ${v}`).join("  ·  ")||"";
frame();
</script></body></html>
"""

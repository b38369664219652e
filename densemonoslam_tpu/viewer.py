"""Live web viewer — the headless substitute for the reference Pangolin GUI.

The reference renders its map with OpenGL in-process (`GUI/src/Tools/GUI.h`,
545 LoC of Pangolin widgets: pause/step/reset/save buttons, draw toggles,
sliders for confidence/depth cutoff/ICP weight/NID threshold, residual/inlier/
NID plots, and a free-look map view; live parameter sync GUI→engine at
`GUI/src/MainController.cpp:768-781`).  An accelerator host is headless, so
the viewer
is a zero-dependency HTTP server (stdlib `http.server`) + a single embedded
HTML page with a hand-written WebGL point-cloud renderer — the browser is the
display, the engine host only encodes small PNGs and a decimated cloud.

Threading model: the HTTP thread never touches the engine or JAX.  The run
loop (CLI or user code) calls `sync(engine, cams)` once per frame — that
single entry point applies queued parameter changes (rebuilding the jitted
step through the engine's step cache, mirroring the reference's live slider
sync), services save/cloud requests, and blocks while paused (honouring
single-step).  `publish(engine, cam)` snapshots what the page polls: predicted
view images (the GUI's per-context `s_cam` views), trajectory, stat logs
(`resLog/inLog/miLog` equivalents, `MainController.cpp:464-471`).
"""

from __future__ import annotations

import functools
import io
import json
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

# parameters the page may change live (the reference GUI's slider set,
# `Tools/GUI.h` confidenceThreshold/depthCutoff/icpWeightPan/nidThreshold/
# nidDepthWeight + pyramid toggles).  Changing one swaps EngineConfig and
# re-derives the jitted step via the engine's step cache: first use of a new
# value compiles once, after that it is a dictionary lookup.
TUNABLE_PARAMS = {
    "confidence_threshold": float,
    "depth_cutoff": float,
    "icp_weight": float,
    "nid_threshold": float,
    "nid_depth_weight": float,
    "fusion_weight_multiplier": float,
    "time_delta": int,
    "fast_odom": bool,
    "so3": bool,
    "nid_keyframing": bool,
}

_CONTROL_ACTIONS = (
    "pause", "resume", "step", "save_ply", "save_traj", "save_images",
    "refresh_cloud", "batch_align",
)


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _view_images(engine, cam: str) -> Dict[str, bytes]:
    """Encode the predicted map view at the camera's pose (the GUI's
    predicted-view panel; `Engine.save_view_images` writes the same images
    to disk)."""
    pred = engine.predict_view(cam)
    rgb = np.clip(np.asarray(pred.color), 0, 255).astype(np.uint8)
    depth = np.asarray(pred.depth)
    d_vis = np.clip(
        depth / max(float(depth.max()), 1e-6) * 255.0, 0, 255
    ).astype(np.uint8)
    nrm = ((np.asarray(pred.nmap) * 0.5 + 0.5) * 255).astype(np.uint8)
    return {
        "rgb": _png_bytes(rgb),
        "depth": _png_bytes(d_vis),
        "normals": _png_bytes(nrm),
    }


@functools.partial(jax.jit, static_argnums=(3,))
def _decimate_cloud(data, count, conf_thresh, max_points):
    """Device-side viewer decimation: gather `max_points` rows spread evenly
    over the allocated range, so the host transfer is a few MB regardless of
    map capacity (a full 2M-surfel snapshot would move 128 MB per refresh)."""
    cnt = jnp.maximum(count, 1)
    idx = (jnp.arange(max_points, dtype=jnp.int32) * cnt) // max_points
    rows = data[jnp.minimum(idx, data.shape[0] - 2)]
    conf = rows[:, 3]
    alive = (conf > 0) & (idx < count)
    stable = alive & (conf > conf_thresh)
    return rows[:, 0:3], rows[:, 4:7], alive, stable


def _cloud_bytes(engine, map_name: str, max_points: int) -> bytes:
    """Decimated stable-surfel cloud as a compact binary blob:
    u32 count | f32 xyz[count*3] | u8 rgb[count*3].  The WebGL page parses it
    with two typed-array views — no JSON for megapoint payloads.  Falls back
    to the unstable cloud early in a session (the GUI's drawUnstable toggle)
    so the view is never blank."""
    m = engine.map_of(map_name)
    pos, col, alive, stable = _decimate_cloud(
        m.data, m.count,
        np.float32(engine.config.confidence_threshold), max_points,
    )
    stable = np.asarray(stable)
    keep = stable if stable.any() else np.asarray(alive)
    pos = np.asarray(pos, np.float32)[keep]
    col = np.clip(np.asarray(col), 0, 255).astype(np.uint8)[keep]
    n = pos.shape[0]
    return struct.pack("<I", n) + pos.tobytes() + col.tobytes()


class ViewerServer:
    """HTTP viewer attached to an `Engine` (reference `GUI` + the
    MainController run-loop glue)."""

    def __init__(
        self,
        engine,
        host: str = "127.0.0.1",
        port: int = 0,
        out_dir: str = ".",
        cloud_max_points: int = 200_000,
        stats_window: int = 240,
        cloud_interval: float = 4.0,
    ):
        self.engine = engine
        self.out_dir = out_dir
        self.cloud_max_points = cloud_max_points
        self.stats_window = stats_window
        self._lock = threading.Lock()
        # published artefacts (HTTP thread reads, run loop writes)
        self._images: Dict[str, Dict[str, bytes]] = {}
        self._status: Dict = {"cams": {}, "paused": False, "params": {}}
        self._trajs: Dict[str, List[List[float]]] = {}
        self._clouds: Dict[str, bytes] = {}
        # control state (HTTP thread writes, run loop consumes via sync())
        self.paused = False
        self._step_once = threading.Event()
        self._pending_params: Dict[str, object] = {}
        self._requests: List[str] = []
        self._cloud_wanted = True  # serve a first cloud without a click
        self._cloud_stamp = 0.0
        self.cloud_interval = cloud_interval
        self._stats_cache: Dict[str, List[List[float]]] = {}
        self._fps: Dict[str, float] = {}
        self._last_pub: Dict[str, tuple] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._host, self._port = host, port

    # ----------------------------------------------------------- lifecycle
    def start(self) -> int:
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self._host, self._port), handler)
        self._port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        return self._port

    @property
    def port(self) -> int:
        return self._port

    def url(self) -> str:
        return f"http://{self._host}:{self._port}/"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # ------------------------------------------------- run-loop entry points
    def publish(self, cam: str) -> None:
        """Snapshot one camera's viewer artefacts (engine thread only)."""
        eng = self.engine
        fe = eng.frontends[cam]
        imgs = _view_images(eng, cam)
        now = time.perf_counter()
        last = self._last_pub.get(cam)
        fps = 0.0
        if last is not None and fe.tick > last[1]:
            fps = (fe.tick - last[1]) / max(now - last[0], 1e-9)
        self._last_pub[cam] = (now, fe.tick)
        if now - self._cloud_stamp > self.cloud_interval:
            # cloud refresh rides the publish cadence (serviced by the next
            # sync()): the page always has a recent map without a click
            with self._lock:
                self._cloud_wanted = True
        # stats tail: realise only rows not yet converted (old rows are long
        # computed, so these fetches do not drain the in-flight pipeline)
        from densemonoslam_tpu import step as stepmod

        cache = self._stats_cache.setdefault(cam, [])
        for i in range(len(cache), len(fe.stats_log)):
            row = np.asarray(fe.stats_log[i])
            cache.append(
                [
                    float(row[stepmod.STAT_ICP_ERR]),
                    float(row[stepmod.STAT_ICP_INL]),
                    float(row[stepmod.STAT_NID]),
                    float(row[stepmod.STAT_SURFELS]),
                ]
            )
        tail = cache[-self.stats_window:]
        traj = np.asarray(fe.pose_hist[: len(fe.ts_log), :3, 3]) if (
            fe.pose_hist is not None and fe.ts_log
        ) else np.zeros((0, 3), np.float32)
        cam_status = {
            "tick": fe.tick,
            "map": fe.map_name,
            "surfels": int(tail[-1][3]) if tail else 0,
            "loops_closed": fe.loops_closed,
            "keyframes": fe.num_keyframes,
            "lost": fe.lost,
            "fps": round(fps, 2),
            "icp_err": [r[0] for r in tail],
            "icp_inl": [r[1] for r in tail],
            "nid": [r[2] for r in tail],
        }
        with self._lock:
            self._images[cam] = imgs
            self._trajs[cam] = traj.tolist()
            self._status["cams"][cam] = cam_status
            self._status["paused"] = self.paused
            self._status["params"] = {
                k: getattr(eng.config, k) for k in TUNABLE_PARAMS
            }
            self._status["maps"] = {
                m: int(np.asarray(be.map_count)) for m, be in eng.maps.items()
            }

    def sync(self, cams: Optional[List[str]] = None) -> None:
        """Per-frame control sync (engine thread).  Applies queued parameter
        edits, services save/cloud requests, and blocks while paused."""
        self._apply_pending(cams)
        while self.paused and not self._step_once.is_set():
            time.sleep(0.05)
            self._apply_pending(cams)
        self._step_once.clear()

    # ------------------------------------------------------------ internals
    def _apply_pending(self, cams: Optional[List[str]]) -> None:
        eng = self.engine
        with self._lock:
            params, self._pending_params = self._pending_params, {}
            reqs, self._requests = self._requests, []
            cloud = self._cloud_wanted
            self._cloud_wanted = False
        if params:
            eng.update_config(**params)
        cams = cams or list(eng.frontends)
        for req in reqs:
            self._service(req, cams)
        if cloud:
            self._cloud_stamp = time.perf_counter()
            for m in list(eng.maps):
                blob = _cloud_bytes(eng, m, self.cloud_max_points)
                with self._lock:
                    self._clouds[m] = blob

    def _service(self, req: str, cams: List[str]) -> None:
        import os

        eng = self.engine
        os.makedirs(self.out_dir, exist_ok=True)
        if req == "save_ply":
            for m in list(eng.maps):
                eng.save_ply(m, os.path.join(self.out_dir, f"{m}.ply"))
        elif req == "save_traj":
            for c in cams:
                eng.save_trajectory(
                    c, os.path.join(self.out_dir, f"{c}.freiburg")
                )
        elif req == "save_images":
            for c in cams:
                eng.save_view_images(c, self.out_dir, prefix=c)
        elif req == "batch_align":
            # reference GUI "Batch Align" button (`MainController.cpp:
            # 815-817`): FGR-style initialisation-free alignment of the
            # first camera living in another map onto the first camera
            out = None
            if len(cams) >= 2:
                a = next(
                    (c for c in cams[1:]
                     if eng.frontends[c].map_name
                     != eng.frontends[cams[0]].map_name),
                    None,
                )
                if a is not None:
                    out = eng.batch_align(a, cams[0], merge=True)
            with self._lock:
                self._status["batch_align"] = (
                    "merged" if out is not None else "rejected"
                )

    # ------------------------------------------------------- HTTP-side API
    def handle_get(self, path: str):
        """Return (status, content_type, body) for a GET (HTTP thread)."""
        if path == "/" or path == "/index.html":
            return 200, "text/html; charset=utf-8", _PAGE.encode()
        if path == "/api/status":
            with self._lock:
                body = json.dumps(self._status).encode()
            return 200, "application/json", body
        if path.startswith("/api/view/"):
            rest = path[len("/api/view/"):]
            parts = rest.split("/")
            if len(parts) == 2:
                cam, kind = parts[0], parts[1].split(".")[0].split("?")[0]
                with self._lock:
                    blob = self._images.get(cam, {}).get(kind)
                if blob is not None:
                    return 200, "image/png", blob
            return 404, "text/plain", b"no such view"
        if path.startswith("/api/traj/"):
            cam = path[len("/api/traj/"):].split("?")[0]
            with self._lock:
                body = json.dumps(self._trajs.get(cam, [])).encode()
            return 200, "application/json", body
        if path.startswith("/api/cloud/"):
            m = path[len("/api/cloud/"):].split("?")[0]
            with self._lock:
                blob = self._clouds.get(m)
            if blob is None:
                return 404, "text/plain", b"cloud not published yet"
            return 200, "application/octet-stream", blob
        return 404, "text/plain", b"not found"

    def handle_post(self, path: str, body: bytes):
        """Return (status, content_type, body) for a POST (HTTP thread)."""
        try:
            payload = json.loads(body or b"{}")
        except json.JSONDecodeError:
            return 400, "application/json", b'{"error": "bad json"}'
        if path == "/api/param":
            accepted = {}
            for k, v in payload.items():
                if k not in TUNABLE_PARAMS:
                    return (
                        400,
                        "application/json",
                        json.dumps({"error": f"not tunable: {k}"}).encode(),
                    )
                accepted[k] = TUNABLE_PARAMS[k](v)
            with self._lock:
                self._pending_params.update(accepted)
            return 200, "application/json", json.dumps({"ok": True}).encode()
        if path == "/api/control":
            action = payload.get("action")
            if action not in _CONTROL_ACTIONS:
                return (
                    400,
                    "application/json",
                    json.dumps({"error": f"unknown action: {action}"}).encode(),
                )
            if action == "pause":
                self.paused = True
            elif action == "resume":
                self.paused = False
            elif action == "step":
                self._step_once.set()
            elif action == "refresh_cloud":
                with self._lock:
                    self._cloud_wanted = True
            else:
                with self._lock:
                    self._requests.append(action)
            return 200, "application/json", json.dumps({"ok": True}).encode()
        return 404, "text/plain", b"not found"


def _make_handler(server: ViewerServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, status, ctype, body):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            try:
                self._send(*server.handle_get(self.path))
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0") or 0)
                body = self.rfile.read(n) if n else b""
                self._send(*server.handle_post(self.path, body))
            except (BrokenPipeError, ConnectionResetError):
                pass

    return Handler


# --------------------------------------------------------------------------
# The page.  One file, no CDN (accelerator hosts may have no egress):
# hand-written WebGL1
# point renderer with orbit/zoom, canvas sparklines for the resLog/inLog/miLog
# equivalents, top-down trajectory plot, live view images, sliders + buttons.
# --------------------------------------------------------------------------
_PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>densemonoslam_tpu viewer</title>
<style>
 body{margin:0;font:13px system-ui,sans-serif;background:#14161a;color:#d8dbe0;display:flex}
 #side{width:270px;min-width:270px;padding:12px;background:#1b1e24;overflow-y:auto;height:100vh;box-sizing:border-box}
 #main{flex:1;display:flex;flex-direction:column;height:100vh}
 #gl{flex:1;min-height:200px}
 #panels{display:flex;flex-wrap:wrap;gap:6px;padding:6px;background:#101214;max-height:45vh;overflow-y:auto}
 .panel{background:#1b1e24;padding:4px;border-radius:4px}
 .panel img{display:block;max-width:320px;image-rendering:pixelated}
 .panel canvas{display:block}
 .cap{color:#8b93a1;font-size:11px;margin:2px 0}
 h3{margin:10px 0 4px;font-size:12px;text-transform:uppercase;color:#8b93a1;letter-spacing:.06em}
 button{background:#2a6df4;color:#fff;border:0;border-radius:4px;padding:5px 10px;margin:2px;cursor:pointer;font-size:12px}
 button.alt{background:#394251}
 label{display:block;margin:6px 0 0}
 input[type=range]{width:100%}
 .v{color:#7fd0ff;float:right}
 #stats div{margin:2px 0}
 .badge{display:inline-block;background:#394251;border-radius:3px;padding:1px 6px;margin:1px;font-size:11px}
 .lost{background:#c0392b}
</style></head><body>
<div id="side">
 <h3>densemonoslam_tpu</h3>
 <div id="stats"></div>
 <h3>Controls</h3>
 <div>
  <button onclick="ctl('pause')">&#10074;&#10074; pause</button>
  <button onclick="ctl('resume')">&#9654; resume</button>
  <button onclick="ctl('step')" class="alt">step</button>
 </div>
 <div>
  <button onclick="ctl('save_ply')" class="alt">save ply</button>
  <button onclick="ctl('save_traj')" class="alt">save traj</button>
  <button onclick="ctl('save_images')" class="alt">save views</button>
 </div>
 <div><button onclick="ctl('refresh_cloud')">&#8635; refresh cloud</button></div>
 <h3>Parameters</h3>
 <div id="params"></div>
 <h3>Cameras</h3>
 <div id="cams"></div>
</div>
<div id="main">
 <canvas id="gl"></canvas>
 <div id="panels"></div>
</div>
<script>
const SLIDERS = [
 ["confidence_threshold",0,30,0.5],["depth_cutoff",0.5,30,0.5],
 ["icp_weight",0,50,1],["nid_threshold",0,1,0.01],
 ["nid_depth_weight",0,1,0.05],["fusion_weight_multiplier",0.1,5,0.1],
];
let status={cams:{},params:{}};
function ctl(a){fetch('/api/control',{method:'POST',body:JSON.stringify({action:a})});}
function setParam(k,v){fetch('/api/param',{method:'POST',body:JSON.stringify({[k]:parseFloat(v)})});}
function el(id){return document.getElementById(id);}

function buildParams(){
 const d=el('params');d.innerHTML='';
 for(const [k,lo,hi,st] of SLIDERS){
  const v=status.params[k];
  const w=document.createElement('label');
  w.innerHTML=`${k}<span class="v" id="v_${k}">${v}</span>
   <input type="range" min="${lo}" max="${hi}" step="${st}" value="${v}"
    onchange="setParam('${k}',this.value)"
    oninput="el('v_${k}').textContent=this.value">`;
  d.appendChild(w);
 }
}
let paramsBuilt=false;

function spark(cv,data,color,label,fmt){
 const c=cv.getContext('2d'),W=cv.width,H=cv.height;
 c.fillStyle='#101214';c.fillRect(0,0,W,H);
 if(!data.length)return;
 const mx=Math.max(...data,1e-12),mn=Math.min(...data,0);
 c.strokeStyle=color;c.beginPath();
 data.forEach((v,i)=>{const x=i/(data.length-1||1)*W,
  y=H-2-(v-mn)/(mx-mn||1)*(H-6);i?c.lineTo(x,y):c.moveTo(x,y);});
 c.stroke();
 c.fillStyle='#8b93a1';c.font='10px monospace';
 c.fillText(`${label} ${fmt(data[data.length-1])}`,4,10);
}

function drawTraj(cv,traj){
 const c=cv.getContext('2d'),W=cv.width,H=cv.height;
 c.fillStyle='#101214';c.fillRect(0,0,W,H);
 if(traj.length<2)return;
 const xs=traj.map(p=>p[0]),zs=traj.map(p=>p[2]);
 const mx=Math.max(...xs),mnx=Math.min(...xs),mz=Math.max(...zs),mnz=Math.min(...zs);
 const s=Math.min((W-12)/(mx-mnx||1),(H-12)/(mz-mnz||1));
 c.strokeStyle='#7fd0ff';c.beginPath();
 traj.forEach((p,i)=>{const x=6+(p[0]-mnx)*s,y=H-6-(p[2]-mnz)*s;
  i?c.lineTo(x,y):c.moveTo(x,y);});
 c.stroke();
 const last=traj[traj.length-1];
 c.fillStyle='#f4b22a';
 c.fillRect(6+(last[0]-mnx)*s-2,H-6-(last[2]-mnz)*s-2,4,4);
 c.fillStyle='#8b93a1';c.font='10px monospace';c.fillText('trajectory (x,z)',4,10);
}

function ensurePanels(){
 const panels=el('panels');
 for(const cam in status.cams){
  if(el('panel_'+cam))continue;
  const d=document.createElement('div');d.className='panel';d.id='panel_'+cam;
  d.innerHTML=`<div class="cap">${cam} predicted rgb / depth / normals</div>
   <div style="display:flex;gap:4px">
    <img id="img_${cam}_rgb"><img id="img_${cam}_depth"><img id="img_${cam}_normals"></div>
   <div style="display:flex;gap:4px;margin-top:4px">
    <canvas id="sp_${cam}_err" width="210" height="44"></canvas>
    <canvas id="sp_${cam}_inl" width="210" height="44"></canvas>
    <canvas id="sp_${cam}_nid" width="210" height="44"></canvas>
    <canvas id="tj_${cam}" width="140" height="88"></canvas></div>`;
  panels.appendChild(d);
 }
}

async function poll(){
 try{
  status=await (await fetch('/api/status')).json();
  if(!paramsBuilt&&Object.keys(status.params).length){buildParams();paramsBuilt=true;}
  ensurePanels();
  let s='';
  for(const [cam,st] of Object.entries(status.cams)){
   s+=`<div><b>${cam}</b> <span class="badge">tick ${st.tick}</span>
    <span class="badge">${st.fps} fps</span>
    <span class="badge">${st.surfels.toLocaleString()} surfels</span>
    <span class="badge">${st.loops_closed} loops</span>
    <span class="badge">${st.keyframes} kf</span>
    ${st.lost?'<span class="badge lost">LOST</span>':''}</div>`;
  }
  if(status.maps)for(const [m,n] of Object.entries(status.maps))
   s+=`<div class="badge">map ${m}: ${n.toLocaleString()}</div>`;
  s+=`<div class="badge">${status.paused?'PAUSED':'running'}</div>`;
  el('stats').innerHTML=s;
  el('cams').innerHTML=Object.keys(status.cams).map(c=>`<span class="badge">${c}</span>`).join('');
  const t=Date.now();
  for(const [cam,st] of Object.entries(status.cams)){
   for(const k of ['rgb','depth','normals'])
    el(`img_${cam}_${k}`).src=`/api/view/${cam}/${k}.png?t=${t}`;
   spark(el(`sp_${cam}_err`),st.icp_err,'#f47f7f','icp err',v=>v.toExponential(2));
   spark(el(`sp_${cam}_inl`),st.icp_inl,'#7ff4a8','inliers',v=>v.toFixed(0));
   spark(el(`sp_${cam}_nid`),st.nid,'#f4b22a','nid',v=>v.toFixed(3));
   const traj=await (await fetch('/api/traj/'+cam)).json();
   drawTraj(el('tj_'+cam),traj);
  }
  for(const m in (status.maps||{}))loadCloud(m);
 }catch(e){}
 setTimeout(poll,600);
}

// ---------------- WebGL point cloud (orbit + zoom, no libraries) ---------
const cv=el('gl');const gl=cv.getContext('webgl');
let prog=null,buf=null,nPts=0,cloudStamp={};
const VS=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;uniform float ps;
 varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;vc=c;}`;
const FS=`precision mediump float;varying vec3 vc;void main(){gl_FragColor=vec4(vc,1.);}`;
function shader(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);return h;}
if(gl){
 prog=gl.createProgram();
 gl.attachShader(prog,shader(gl.VERTEX_SHADER,VS));
 gl.attachShader(prog,shader(gl.FRAGMENT_SHADER,FS));
 gl.linkProgram(prog);
}
let rotX=-0.4,rotY=0.6,dist=4.0,panX=0,panY=0,drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panX+=dx*0.005*dist;panY-=dy*0.005*dist;}
 else{rotY+=dx*0.008;rotX+=dy*0.008;}
 drag=[e.clientX,e.clientY,drag[2]];};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function mat(){ // perspective * view (column-major)
 const a=cv.width/cv.height,f=1.6,n=0.05,fa=500;
 const P=[f/a,0,0,0, 0,f,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
 const cx=Math.cos(rotX),sx=Math.sin(rotX),cy=Math.cos(rotY),sy=Math.sin(rotY);
 // orbit: translate(pan, -dist) * rotX * rotY
 const R=[cy,sx*sy,-cx*sy,0, 0,cx,sx,0, sy,-sx*cy,cx*cy,0, panX,panY,-dist,1];
 const M=new Array(16).fill(0);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
  M[j*4+i]+=P[k*4+i]*R[j*4+k];
 return M;
}
async function loadCloud(m){
 if(cloudStamp[m]&&Date.now()-cloudStamp[m]<4000)return;
 cloudStamp[m]=Date.now();
 try{
  const r=await fetch('/api/cloud/'+m);if(!r.ok)return;
  const ab=await r.arrayBuffer();
  const n=new Uint32Array(ab,0,1)[0];
  const pos=new Float32Array(ab,4,n*3);
  const col=new Uint8Array(ab,4+n*12,n*3);
  const inter=new Float32Array(n*6);
  // centre the cloud so orbit pivots on it
  let mx=0,my=0,mz=0;
  for(let i=0;i<n;i++){mx+=pos[i*3];my+=pos[i*3+1];mz+=pos[i*3+2];}
  mx/=n||1;my/=n||1;mz/=n||1;
  for(let i=0;i<n;i++){
   inter[i*6]=pos[i*3]-mx;inter[i*6+1]=-(pos[i*3+1]-my);inter[i*6+2]=-(pos[i*3+2]-mz);
   inter[i*6+3]=col[i*3]/255;inter[i*6+4]=col[i*3+1]/255;inter[i*6+5]=col[i*3+2]/255;}
  if(!buf)buf=gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER,buf);
  gl.bufferData(gl.ARRAY_BUFFER,inter,gl.DYNAMIC_DRAW);
  nPts=n;
 }catch(e){}
}
function draw(){
 if(gl&&prog){
  cv.width=cv.clientWidth;cv.height=cv.clientHeight;
  gl.viewport(0,0,cv.width,cv.height);
  gl.clearColor(0.06,0.07,0.09,1);gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.enable(gl.DEPTH_TEST);
  if(nPts>0){
   gl.useProgram(prog);
   gl.bindBuffer(gl.ARRAY_BUFFER,buf);
   const lp=gl.getAttribLocation(prog,'p'),lc=gl.getAttribLocation(prog,'c');
   gl.enableVertexAttribArray(lp);gl.vertexAttribPointer(lp,3,gl.FLOAT,false,24,0);
   gl.enableVertexAttribArray(lc);gl.vertexAttribPointer(lc,3,gl.FLOAT,false,24,12);
   gl.uniformMatrix4fv(gl.getUniformLocation(prog,'mvp'),false,new Float32Array(mat()));
   gl.uniform1f(gl.getUniformLocation(prog,'ps'),2.0);
   gl.drawArrays(gl.POINTS,0,nPts);
  }
 }
 requestAnimationFrame(draw);
}
draw();poll();
</script></body></html>
"""

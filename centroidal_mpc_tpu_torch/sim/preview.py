"""Standalone HTML 3D motion preview.

Copy of `centroidal_mpc_tpu/sim/preview.py`, reading the port's
`PipelineResult` (tensors, read to the host; the SCP solutions' B = 1
axis).  The reference previews motions in meshcat cells inside its demo
notebooks (demos/trot_demo.ipynb cells 5/9: `robot.display(...)` over the
interpolated whole-body solution).  A headless deployment has no meshcat
server and no network, so the equivalent here is a fully
self-contained HTML file: the sampled motion (base, leg skeleton, feet,
CoM path, terrain stones) is embedded as JSON and rendered by an inline
canvas software-3D renderer -- no external scripts, works file:// and
offline.

`write_motion_preview(result, preset, out_dir)` is the pipeline-facing
entry (the `run-motion` command); `motion_preview_html(...)` is the pure
array-level builder the tests drive.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from centroidal_mpc_tpu_torch.models import kinematics as kin


def _np(a) -> np.ndarray:
    """A tensor or array-like as a float64 numpy array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _knee_positions(q: np.ndarray, sides: np.ndarray,
                    l_upper: float, y_off: float) -> np.ndarray:
    """Knee points in the HIP frame from (haa, hfe, kfe) joint angles.

    Matches models/kinematics.leg_fk: the sagittal 2-link chain hangs
    below the HFE axis, HAA rotates the leg plane about base x.
    q: (T, L, 3); sides: (L,).  Returns (T, L, 3).
    """
    haa, hfe = q[..., 0], q[..., 1]
    px = -l_upper * np.sin(hfe)
    pz = -l_upper * np.cos(hfe)
    py = np.broadcast_to(sides * y_off, haa.shape)
    c, s = np.cos(haa), np.sin(haa)
    return np.stack([px, c * py - s * pz, s * py + c * pz], axis=-1)


def motion_preview_html(base: np.ndarray, feet: np.ndarray,
                        stance: np.ndarray, dt: float,
                        com_path: Optional[np.ndarray] = None,
                        q: Optional[np.ndarray] = None,
                        hips_body: Optional[np.ndarray] = None,
                        sides: Optional[np.ndarray] = None,
                        l_upper: float = 0.16, y_off: float = 0.014,
                        foot_names: Sequence[str] = (),
                        stones: Sequence[dict] = (),
                        title: str = "centroidal-mpc-tpu motion preview",
                        max_frames: int = 600) -> str:
    """Build the standalone HTML string.

    base: (T, 3) base/CoM positions per frame.
    feet: (T, L, 3) world foot positions.
    stance: (T, L) 1=stance 0=swing per frame.
    q: optional (T, L, 3) leg joint angles -> knees drawn via FK.
    hips_body: (L, 3) hip offsets in the base frame (identity base
      orientation, matching the kinematic whole-body layer).
    stones: [{"c": [x,y,z], "size": [lx,ly], "R": 3x3 row-major}].
    """
    base = np.asarray(base, np.float64)
    feet = np.asarray(feet, np.float64)
    stance = np.asarray(stance, np.float64)
    T, L = feet.shape[0], feet.shape[1]
    stride = max(1, T // max_frames)
    sl = slice(0, T, stride)
    base_s, feet_s, st_s = base[sl], feet[sl], stance[sl]

    if hips_body is None:
        # generic rectangle around the base sized to the foot spread
        span = np.nanmax(np.abs(feet[..., :2] - base[:, None, :2]),
                         axis=(0, 1))
        if L == 4:
            hips_body = np.array(
                [[span[0], -span[1], 0.0], [span[0], span[1], 0.0],
                 [-span[0], -span[1], 0.0], [-span[0], span[1], 0.0]])
        else:
            hips_body = np.zeros((L, 3))
            hips_body[:, 1] = np.linspace(-span[1], span[1], L)
    hips_body = np.asarray(hips_body, np.float64)
    hips_s = base_s[:, None, :] + hips_body[None, :, :]

    if q is not None and sides is not None:
        knees_hip = _knee_positions(np.asarray(q)[sl], np.asarray(sides),
                                    l_upper, y_off)
        knees_s = hips_s + knees_hip
    else:
        knees_s = 0.5 * (hips_s + feet_s)

    data = {
        "dt": dt * stride,
        "base": np.round(base_s, 4).tolist(),
        "hips": np.round(hips_s, 4).tolist(),
        "knees": np.round(knees_s, 4).tolist(),
        "feet": np.round(feet_s, 4).tolist(),
        "stance": st_s.astype(int).tolist(),
        "com": (np.round(np.asarray(com_path, np.float64), 4).tolist()
                if com_path is not None else np.round(base_s, 4).tolist()),
        "footNames": list(foot_names) or [f"foot{i}" for i in range(L)],
        "stones": [{"c": [round(float(v), 4) for v in s["c"]],
                    "size": [round(float(v), 4) for v in s["size"]],
                    "R": [round(float(v), 6) for v in
                          np.asarray(s["R"], np.float64).reshape(-1)]}
                   for s in stones],
        "title": title,
    }
    return _HTML_TEMPLATE.replace("__DATA__", json.dumps(data))


def write_motion_preview(result, preset, out_dir: str,
                         filename: str = "motion_preview.html") -> str:
    """Extract the best available motion from a PipelineResult and write
    the HTML preview (the reference's meshcat cells 5/9 counterpart)."""
    plan = result.problem.plan
    X = _np(result.nominal.X[0])
    sched_pos = _np(plan.schedule.position)
    sched_logic = _np(plan.schedule.logic)

    stones = []
    terr = getattr(result, "terrain", None)
    if terr is not None:
        for s in terr.stones:
            stones.append({"c": [s.center[0], s.center[1], s.height],
                           "size": list(s.size), "R": s.rotation()})

    wb = getattr(result, "wb_traj", None)
    if wb is not None:
        geom = kin.SOLO12_LEGS if preset.robot.n_contacts == 4 \
            else kin.BOLT_LEGS
        q = _np(wb.q)
        Tn, L = q.shape[0], q.shape[1] // 3
        html = motion_preview_html(
            base=_np(wb.base_pos), feet=_np(wb.feet),
            stance=_stance_at_ctrl(sched_logic, Tn),
            dt=preset.dt_ctrl, com_path=X[:, :3],
            q=q.reshape(Tn, L, 3),
            hips_body=np.asarray(geom.hip_positions(), np.float64),
            sides=np.asarray(geom.side_signs(), np.float64),
            l_upper=geom.l_upper, y_off=geom.y_off,
            foot_names=preset.robot.foot_names, stones=stones,
            title=f"{preset.name} whole-body preview")
    else:
        # planning-knot fallback: CoM + scheduled foot placements
        n = min(X.shape[0], sched_pos.shape[0])
        html = motion_preview_html(
            base=X[:n, :3], feet=sched_pos[:n], stance=sched_logic[:n],
            dt=preset.dt, com_path=X[:, :3],
            foot_names=preset.robot.foot_names, stones=stones,
            title=f"{preset.name} centroidal preview")

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, filename)
    with open(path, "w") as f:
        f.write(html)
    return path


def _stance_at_ctrl(logic: np.ndarray, T: int) -> np.ndarray:
    """Resample per-knot contact logic (N, L) to T control ticks."""
    N = logic.shape[0]
    idx = np.minimum((np.arange(T) * N) // max(T, 1), N - 1)
    return logic[idx]


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>motion preview</title>
<style>
 body{margin:0;background:#14161a;color:#cfd3da;font:13px system-ui,sans-serif}
 #bar{position:fixed;left:0;right:0;bottom:0;padding:8px 12px;background:#1c1f24;
      display:flex;gap:10px;align-items:center}
 #bar input[type=range]{flex:1}
 button{background:#2b313a;color:#cfd3da;border:0;border-radius:4px;
        padding:4px 12px;cursor:pointer}
 #hud{position:fixed;top:8px;left:12px;opacity:.8}
</style></head><body>
<canvas id="cv"></canvas>
<div id="hud"></div>
<div id="bar">
 <button id="play">&#9654;/&#10074;&#10074;</button>
 <input id="scrub" type="range" min="0" max="1" step="1" value="0">
 <span id="tlab"></span>
 <label>speed <select id="speed">
   <option>0.25</option><option selected>1</option><option>2</option>
 </select></label>
</div>
<script>
const D = __DATA__;
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const T = D.base.length, L = D.feet[0].length;
let yaw = -0.9, pitch = 0.45, dist = 1.6, frame = 0, playing = true;
let center = D.base[0].slice();
function resize(){cv.width=innerWidth;cv.height=innerHeight-44;}
addEventListener('resize', resize); resize();
let drag=null;
cv.addEventListener('mousedown', e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup', ()=>drag=null);
addEventListener('mousemove', e=>{ if(!drag) return;
  yaw += (e.clientX-drag[0])*0.01; pitch += (e.clientY-drag[1])*0.01;
  pitch = Math.max(0.05, Math.min(1.5, pitch)); drag=[e.clientX,e.clientY];});
cv.addEventListener('wheel', e=>{dist*=Math.exp(e.deltaY*0.001);
  e.preventDefault();});
function proj(p){
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  const x=p[0]-center[0], y=p[1]-center[1], z=p[2]-center[2]*0;
  const X =  cy*x + sy*y;
  const Y = -sy*cp*x + cy*cp*y + sp*z;
  const Zc = sy*sp*x - cy*sp*y + cp*z + dist;   // camera depth
  const f = 0.9*Math.min(cv.width,cv.height)/Math.max(Zc,0.05);
  return [cv.width/2 + f*X, cv.height*0.55 - f*Y, Zc];
}
function line(a,b,color,w){const A=proj(a),B=proj(b);
  ctx.strokeStyle=color; ctx.lineWidth=w||1.4;
  ctx.beginPath(); ctx.moveTo(A[0],A[1]); ctx.lineTo(B[0],B[1]);
  ctx.stroke();}
function dot(p,color,r){const A=proj(p); ctx.fillStyle=color;
  ctx.beginPath(); ctx.arc(A[0],A[1],r||4,0,6.3); ctx.fill();}
function poly(pts,fill){ctx.fillStyle=fill; ctx.beginPath();
  pts.forEach((p,i)=>{const A=proj(p);
    i?ctx.lineTo(A[0],A[1]):ctx.moveTo(A[0],A[1]);});
  ctx.closePath(); ctx.fill();}
function draw(){
  ctx.clearRect(0,0,cv.width,cv.height);
  center = [D.base[frame][0], D.base[frame][1], 0];
  // ground grid
  for(let i=-8;i<=8;i++){
    const g=0.1*i, ex=0.8;
    line([center[0]-ex, center[1]+g, 0],[center[0]+ex, center[1]+g,0],
         '#262b33');
    line([center[0]+g, center[1]-ex, 0],[center[0]+g, center[1]+ex,0],
         '#262b33');}
  // stones
  for(const s of D.stones){
    const R=s.R, hx=s.size[0]/2, hy=s.size[1]/2, c=s.c;
    const cs=[[-hx,-hy],[hx,-hy],[hx,hy],[-hx,hy]].map(([u,v])=>[
      c[0]+R[0]*u+R[1]*v, c[1]+R[3]*u+R[4]*v, c[2]+R[6]*u+R[7]*v]);
    poly(cs,'rgba(120,110,90,0.55)');}
  // CoM plan path
  ctx.strokeStyle='#4f8ef7'; ctx.lineWidth=1.2; ctx.beginPath();
  D.com.forEach((p,i)=>{const A=proj(p);
    i?ctx.lineTo(A[0],A[1]):ctx.moveTo(A[0],A[1]);});
  ctx.stroke();
  // base box
  const b=D.base[frame], bw=0.09, bl=0.16, bh=0.03;
  const cs=[];
  for(const dx of [-bl,bl]) for(const dy of [-bw,bw])
    for(const dz of [-bh,bh]) cs.push([b[0]+dx,b[1]+dy,b[2]+dz]);
  const E=[[0,1],[2,3],[4,5],[6,7],[0,2],[1,3],[4,6],[5,7],
           [0,4],[1,5],[2,6],[3,7]];
  for(const [i,j] of E) line(cs[i],cs[j],'#9aa4b2',1.6);
  dot(b,'#4f8ef7',5);
  // legs
  for(let l=0;l<L;l++){
    const hip=D.hips[frame][l], knee=D.knees[frame][l],
          ft=D.feet[frame][l], st=D.stance[frame][l];
    line(b,hip,'#6b7585',1.6);
    line(hip,knee,'#c9a227',2.2); line(knee,ft,'#c9a227',2.2);
    dot(ft, st? '#3fb950':'#e5534b', st?4.5:3.5);
    // foot trail
    ctx.strokeStyle='rgba(201,162,39,0.35)'; ctx.lineWidth=1;
    ctx.beginPath();
    for(let k=Math.max(0,frame-120);k<=frame;k++){
      const A=proj(D.feet[k][l]);
      k===Math.max(0,frame-120)?ctx.moveTo(A[0],A[1]):ctx.lineTo(A[0],A[1]);}
    ctx.stroke();
  }
  document.getElementById('hud').textContent =
    D.title+'  |  t = '+(frame*D.dt).toFixed(2)+' s  ('+(frame+1)+'/'+T+
    ')  drag = orbit, wheel = zoom';
  document.getElementById('tlab').textContent=(frame*D.dt).toFixed(2)+'s';
}
const scrub=document.getElementById('scrub'); scrub.max=T-1;
scrub.oninput=()=>{frame=+scrub.value; playing=false; draw();};
document.getElementById('play').onclick=()=>playing=!playing;
let last=0;
function tick(ts){
  const sp=+document.getElementById('speed').value;
  if(playing && ts-last > 1000*D.dt/sp){
    frame=(frame+1)%T; scrub.value=frame; last=ts;}
  draw(); requestAnimationFrame(tick);}
requestAnimationFrame(tick);
</script></body></html>
"""

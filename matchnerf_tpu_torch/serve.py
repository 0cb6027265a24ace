"""Render server of the port (counterpart of matchnerf_tpu/serve.py): keep
the model on the card, encode each scene once, serve novel-view renders over
HTTP.

A scene's sampling tables (the encoder's int8 features, the uint8 and
supercell colour tables of configs/test.yaml) stay on the device between
requests, so a render costs only the target pose's route (`pose_prep` on the
block path) and the render slices. Scenes past `max_scenes` are evicted,
least recently used first; eviction and DELETE drop the scene's only
reference to its tensors, which frees them.

Design:
- stdlib ThreadingHTTPServer; one device lock serialises every CUDA call
  (upload, encode, tables, render and the copy back to the host), and the
  scene cache is read and changed under it too. Handler threads overlap only
  the JSON and base64 work.
- the kernels build on their first launch; build or launch errors reach the
  client as a 400 with the exception's text. Nothing falls back to the CPU
  or to a plain version.

Endpoints (JSON request/response; arrays as base64 of little-endian bytes
with explicit dtype/shape), the JAX server's:
  GET  /healthz            -> {ok, backend ("cuda" or "cpu"), n_scenes, uptime_s}
  POST /scenes             -> {scene_id}
        {images: arr [V,H,W,3] float32 in [0,1] (or uint8),
         extrinsics: arr [V,3,4] or [V,4,4] world->cam,
         intrinsics: arr [V,3,3], near_fars: arr [V,2],
         c2ws_all?: arr [M,3,4] or [M,4,4] cam->world, all captured camera
         poses of the scene (the spiral's centre and radii)}
  POST /render             -> {rgb: arr [H,W,3] uint8 (or float32),
                               depth: arr [H,W] float32}
        {scene_id, extrinsic: arr [3,4] or [4,4] world->cam,
         intrinsic: arr [3,3], near_far: arr [2],
         out_dtype: "uint8"|"float32" (default uint8)}
  POST /render_path        -> {frames: arr [n,H,W,3] uint8}
        {scene_id, n_frames (default 8), mode: "interpolate"|"spiral",
         intrinsic?: arr [3,3], near_far?: arr [2] (default: ref view 0),
         c2ws_all?: arr [M,3,4|4,4] (spiral only; overrides the scene's;
         when neither exists, the spiral orbits the V source cameras)}
  DELETE /scenes/<id>      -> {ok}

    python -m matchnerf_tpu_torch.serve --config test [--load=PATH | --random_init] \\
        [--cpu] [--port 8000] [--host 127.0.0.1] [--max_scenes 8] [--key.sub=value ...]

`--config` names a configuration of `config.CONFIGS` (default test); every
other `--key=value` overrides it as in `python -m matchnerf_tpu_torch.test`.
It serves on the card unless given `--cpu`, and exits with an error where
there is no CUDA device.
"""
from __future__ import annotations

import argparse
import base64
import json
import logging
import sys
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from . import camera
from .renderer import Renderer

log = logging.getLogger(__name__)


def encode_array(a: np.ndarray) -> Dict:
    a = np.ascontiguousarray(a)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d: Dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"]).copy()


def _to34(e: np.ndarray) -> np.ndarray:
    """[...,4,4] or [...,3,4] -> [...,3,4] float32."""
    e = np.asarray(e, np.float32)
    return e[..., :3, :] if e.shape[-2] == 4 else e


def _to44(e: np.ndarray) -> np.ndarray:
    """[...,3,4] or [...,4,4] -> [...,4,4] float32 (homogeneous row added)."""
    e = np.asarray(e, np.float32)
    if e.shape[-2] == 4:
        return e
    sq = np.broadcast_to(np.eye(4, dtype=np.float32), (*e.shape[:-2], 4, 4)).copy()
    sq[..., :3, :] = e
    return sq


def _to_u8(rgb: np.ndarray) -> np.ndarray:
    return np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)


class RenderService:
    """Model, scene cache and device lock; the HTTP-free core.

    `last_timings` holds the seconds of the last request's device work,
    measured inside the lock and ended by the copy to the host: "encode_s"
    (upload, encode and tables) for a scene, "render_s" and "pose_prep_s"
    (the block path's route, part of render_s) for a render or a path."""

    def __init__(self, cfg, model, device="cuda", max_scenes: int = 8):
        self.cfg = cfg
        self.renderer = Renderer(cfg, model, device)
        self.scenes: "OrderedDict[str, Dict]" = OrderedDict()
        self.max_scenes = max_scenes
        self.device_lock = threading.Lock()
        self.t0 = time.time()
        self._n = 0
        self.last_timings: Dict[str, float] = {}

    def health(self) -> Dict:
        return {"ok": True, "backend": self.renderer.device.type,
                "n_scenes": len(self.scenes),
                "uptime_s": round(time.time() - self.t0, 1)}

    def _touch(self, sid: str) -> Dict:
        """The scene, made the most recently used; KeyError if absent.
        Call under the device lock."""
        sc = self.scenes.get(sid)
        if sc is None:
            raise KeyError(sid)
        self.scenes.move_to_end(sid)
        return sc

    def add_scene(self, images: np.ndarray, extrinsics: np.ndarray,
                  intrinsics: np.ndarray, near_fars: np.ndarray,
                  c2ws_all: Optional[np.ndarray] = None) -> str:
        V = int(self.cfg.n_src_views)
        if images.ndim != 4 or images.shape[0] != V:
            raise ValueError(f"images {images.shape}: the model takes [{V},H,W,3]")
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        images = np.asarray(images[None], np.float32)                 # [1,V,H,W,3]
        with self.device_lock:
            t0 = time.perf_counter()
            ref_images = self.renderer.tensor(images)
            tables = self.renderer.build_tables(ref_images, self.renderer.encode(ref_images))
            if self.renderer.device.type == "cuda":
                torch.cuda.synchronize(self.renderer.device)
            self.last_timings = {"encode_s": time.perf_counter() - t0}
            self._n += 1
            sid = f"scene-{self._n:06d}"
            self.scenes[sid] = {
                "tables": tables,
                "H": images.shape[2], "W": images.shape[3],
                "ref": {
                    "extrinsics": _to34(extrinsics)[None],               # [1,V,3,4]
                    "intrinsics": np.asarray(intrinsics, np.float32)[None],
                    "near_fars": np.asarray(near_fars, np.float32)[None],
                },
                "c2ws_all": None if c2ws_all is None else _to44(c2ws_all),
            }
            while len(self.scenes) > self.max_scenes:
                evicted, _ = self.scenes.popitem(last=False)
                log.info("serve: evicted %s (LRU, cap %d)", evicted, self.max_scenes)
        return sid

    def drop_scene(self, sid: str) -> bool:
        with self.device_lock:
            return self.scenes.pop(sid, None) is not None

    def _render(self, sc: Dict, tgt: Dict, timings: Dict) -> Dict[str, torch.Tensor]:
        """One target pose of a scene; under the device lock."""
        return self.renderer.render_by_slices({"tgt": tgt, "ref": sc["ref"]}, sc["tables"],
                                              sc["H"], sc["W"], timings=timings)

    def _timed(self, t0: float, timings: Dict):
        self.last_timings = {"render_s": time.perf_counter() - t0,
                             "pose_prep_s": timings.get("pose_prep", 0.0)}

    def render_path(self, sid: str, n_frames: int = 8, mode: str = "interpolate",
                    intrinsic: Optional[np.ndarray] = None,
                    near_far: Optional[np.ndarray] = None,
                    c2ws_all: Optional[np.ndarray] = None) -> np.ndarray:
        """A novel camera trajectory (`Renderer.get_video_rendering_path`):
        'interpolate' between the scene's source poses, or 'spiral' around
        c2ws_all (the request's, else the scene's, else the V source-camera
        poses). Returns uint8 frames [n,H,W,3]."""
        with self.device_lock:
            if sid not in self.scenes:
                raise KeyError(sid)
            if mode not in ("interpolate", "spiral"):
                raise ValueError(f"render_path supports mode='interpolate' or "
                                 f"'spiral' (got {mode!r})")
            sc = self._touch(sid)
            H, W = sc["H"], sc["W"]
            intr = (np.asarray(intrinsic, np.float32) if intrinsic is not None
                    else sc["ref"]["intrinsics"][0, 0])
            nf = (np.asarray(near_far, np.float32) if near_far is not None
                  else sc["ref"]["near_fars"][0, 0])
            poses = {"ref": sc["ref"], "tgt": {"intrinsics": intr[None], "near_fars": nf[None]}}
            batch = None
            if mode == "spiral":
                c2a = c2ws_all if c2ws_all is not None else sc["c2ws_all"]
                if c2a is None:
                    c2a = camera.pose_inverse_legacy_np(sc["ref"]["extrinsics"][0])  # [V,3,4]
                batch = {"c2ws_all": _to44(c2a)[None]}                          # [1,M,4,4]
            frame_poses = self.renderer.get_video_rendering_path(poses, mode, int(n_frames),
                                                                 batch=batch)
            t0, timings = time.perf_counter(), {}
            frames: List[np.ndarray] = []
            for fp in frame_poses:
                out = self._render(sc, fp, timings)
                frames.append(out["rgb"].reshape(H, W, 3).float().cpu().numpy())
            self._timed(t0, timings)
        return np.stack([_to_u8(f) for f in frames])

    def render(self, sid: str, extrinsic: np.ndarray, intrinsic: np.ndarray,
               near_far: np.ndarray, out_dtype: str = "uint8") -> Dict[str, np.ndarray]:
        tgt = {"extrinsics": _to34(extrinsic)[None],                   # [1,3,4]
               "intrinsics": np.asarray(intrinsic, np.float32)[None],
               "near_fars": np.asarray(near_far, np.float32)[None]}
        with self.device_lock:
            sc = self._touch(sid)
            H, W = sc["H"], sc["W"]
            t0, timings = time.perf_counter(), {}
            out = self._render(sc, tgt, timings)
            rgb = out["rgb"].reshape(H, W, 3).float().cpu().numpy()
            depth = out["depth"].reshape(H, W).float().cpu().numpy()
            self._timed(t0, timings)
        rgb_out = _to_u8(rgb) if out_dtype == "uint8" else rgb
        return {"rgb": rgb_out, "depth": depth}


def make_handler(svc: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):                      # quiet access log
            pass

        def _json(self, code: int, obj: Dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> Dict:
            n = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, svc.health())
            return self._json(404, {"error": f"no route {self.path}"})

        def do_DELETE(self):
            if self.path.startswith("/scenes/"):
                ok = svc.drop_scene(self.path[len("/scenes/"):])
                return self._json(200 if ok else 404, {"ok": ok})
            return self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            try:
                req = self._body()
                if self.path == "/scenes":
                    sid = svc.add_scene(
                        decode_array(req["images"]), decode_array(req["extrinsics"]),
                        decode_array(req["intrinsics"]), decode_array(req["near_fars"]),
                        c2ws_all=(decode_array(req["c2ws_all"]) if "c2ws_all" in req
                                  else None))
                    return self._json(200, {"scene_id": sid})
                if self.path == "/render":
                    sid = req["scene_id"]
                    extr = decode_array(req["extrinsic"])
                    intr = decode_array(req["intrinsic"])
                    nf = decode_array(req["near_far"])
                    try:
                        out = svc.render(sid, extr, intr, nf,
                                         out_dtype=req.get("out_dtype", "uint8"))
                    except KeyError as e:
                        return self._json(404, {"error": f"unknown scene {e}"})
                    return self._json(200, {"rgb": encode_array(out["rgb"]),
                                            "depth": encode_array(out["depth"])})
                if self.path == "/render_path":
                    sid = req["scene_id"]
                    intr = decode_array(req["intrinsic"]) if "intrinsic" in req else None
                    nf = decode_array(req["near_far"]) if "near_far" in req else None
                    try:
                        frames = svc.render_path(
                            sid, n_frames=int(req.get("n_frames", 8)),
                            mode=req.get("mode", "interpolate"), intrinsic=intr, near_far=nf,
                            c2ws_all=(decode_array(req["c2ws_all"]) if "c2ws_all" in req
                                      else None))
                    except KeyError as e:
                        return self._json(404, {"error": f"unknown scene {e}"})
                    return self._json(200, {"frames": encode_array(frames)})
                return self._json(404, {"error": f"no route {self.path}"})
            except Exception as e:                              # noqa: BLE001
                log.warning("serve: %s: %s", type(e).__name__, e, exc_info=True)
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(cfg, model, port: int = 8000, host: str = "127.0.0.1", max_scenes: int = 8,
          device="cuda") -> ThreadingHTTPServer:
    """The service and a ready server; the caller runs `serve_forever()`,
    possibly on a thread, and `shutdown()` / `server_close()` it.
    `httpd.service` is the RenderService."""
    svc = RenderService(cfg, model, device=device, max_scenes=max_scenes)
    httpd = ThreadingHTTPServer((host, port), make_handler(svc))
    httpd.service = svc
    return httpd


def build_server(argv: Optional[List[str]] = None) -> ThreadingHTTPServer:
    """The command line's server, not yet serving: the configuration with
    its overrides, the model (seeded, then the weights of `load` unless
    --random_init) on the card, or on the CPU with --cpu."""
    from .config import CONFIGS, override_options, parse_arguments
    from .models.matchnerf import init_matchnerf
    from .utils.checkpoint import load_model_weights

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--max_scenes", type=int, default=8)
    parser.add_argument("--random_init", action="store_true",
                        help="serve the seeded random weights (smoke runs)")
    parser.add_argument("--cpu", action="store_true", help="serve on the CPU")
    args, rest = parser.parse_known_args(sys.argv[1:] if argv is None else argv)
    opts = parse_arguments(rest)
    name = opts.pop("config", "test")
    if name not in CONFIGS:
        raise SystemExit(f"unknown --config {name!r}; the port has {sorted(CONFIGS)}")
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device (torch.cuda.is_available() is False); "
                         "pass --cpu to serve on the CPU")
    cfg = override_options(CONFIGS[name](), opts)
    model = init_matchnerf(cfg, torch.Generator().manual_seed(int(cfg.get("seed") or 0)))
    load = cfg.get("load")
    if load and not args.random_init:
        load_model_weights(model, load)
        log.info("serve: loaded weights from %s", load)
    elif not args.random_init:
        log.warning("serve: no --load given — serving RANDOM weights")
    model = model.to(device).eval()
    httpd = serve(cfg, model, port=args.port, host=args.host, max_scenes=args.max_scenes,
                  device=device)
    log.info("serve: config %s listening on http://%s:%d (backend=%s)", name,
             args.host, httpd.server_address[1], device)
    return httpd


def main(argv: Optional[List[str]] = None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    httpd = build_server(argv)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()

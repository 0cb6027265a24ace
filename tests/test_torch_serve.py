"""The port's render server (`matchnerf_tpu_torch.serve`) against the JAX
server (`matchnerf_tpu.serve`) on the CPU, both over the real HTTP wire on
127.0.0.1, from the same JAX PRNG(0) weights (carried across by
`weights.state_dict_from_jax`) and the same numpy scenes: the tiny setup of
tests/test_serve.py (2 transformer layers, S=8, 64-ray slices, 32x32).

Required agreement: rgb at PSNR >= 60 dB (the repo's budget for
reassociation between the frameworks) and depth within 1e-3 on /render;
/render_path frames within 1 level of uint8. The port's HTTP render equals
its direct `Renderer.render_by_slices` render bit for bit (also on the
block path of configs/test.yaml's precision), concurrent requests equal
serial ones bit for bit, and every error gives the JAX server's status code
and text. The command line builds the service on the CPU with --cpu and
refuses to start where there is no CUDA device.
"""
import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from matchnerf_tpu.models.matchnerf import init_matchnerf as jax_init
from matchnerf_tpu.serve import serve as jax_serve
from matchnerf_tpu.utils import DotDict
from matchnerf_tpu_torch import camera
from matchnerf_tpu_torch.config import dtu_eval_config
from matchnerf_tpu_torch.models.matchnerf import MatchNeRF
from matchnerf_tpu_torch.serve import build_server, decode_array, encode_array, serve
from matchnerf_tpu_torch.weights import state_dict_from_jax
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 32
RGB_PSNR_DB = 60.0
DEPTH_TOL = 1e-3


def _tiny_cfg(precision=None):
    cfg = DotDict(dict(ge._tiny_cfg(n_layers=2, sample_intvs=8)))
    cfg.nerf.rand_rays_test = 64
    if precision is not None:
        cfg.precision = DotDict(precision)
    return cfg


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def _call(port, method, path, obj=None, raw=None):
    data = raw if raw is not None else (None if obj is None else json.dumps(obj).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _start(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t


def _stop(httpd, t):
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def servers():
    """(JAX httpd, port httpd, the port's model): one server per package,
    max_scenes 2, on ephemeral ports."""
    params = jax_init(jax.random.PRNGKey(0), _tiny_cfg())
    cfg = _tiny_cfg()
    model = MatchNeRF(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()
    jx = jax_serve(_tiny_cfg(), params, port=0, max_scenes=2)
    pt = serve(cfg, model, port=0, max_scenes=2, device="cpu")
    threads = [_start(jx), _start(pt)]
    yield jx, pt, model
    for httpd, t in zip((jx, pt), threads):
        _stop(httpd, t)


def _both(servers, method, path, obj=None, raw=None):
    """The same request to the JAX server, then the port's."""
    return [_call(s.server_address[1], method, path, obj, raw) for s in servers[:2]]


def _scene(seed=0, c2ws_all=False):
    d = ge._synthetic_inputs(_tiny_cfg(), 1, H, W, 8, seed=seed)
    V = 3
    payload = {"images": encode_array(d["images"][0, :V]),
               "extrinsics": encode_array(d["poses"][0, :V]),
               "intrinsics": encode_array(d["intr"][0, :V]),
               "near_fars": encode_array(d["near_fars"][0, :V])}
    if c2ws_all:          # every camera of the scene, the target's too
        payload["c2ws_all"] = encode_array(camera.pose_inverse_legacy_np(d["poses"][0]))
    return payload, d


def _target(sid, d, out_dtype="float32"):
    return {"scene_id": sid, "extrinsic": encode_array(d["poses"][0, -1]),
            "intrinsic": encode_array(d["intr"][0, -1]),
            "near_far": encode_array(d["near_fars"][0, -1]), "out_dtype": out_dtype}


def _add_both(servers, seed=0, c2ws_all=False):
    payload, d = _scene(seed, c2ws_all)
    (cj, rj), (cp, rp) = _both(servers, "POST", "/scenes", payload)
    assert cj == 200 and cp == 200, (rj, rp)
    return rj["scene_id"], rp["scene_id"], d


def _direct(svc, sid, d):
    """The port's render of the scene's target without the server: the
    service's Renderer on the scene's stored tables."""
    sc = svc.scenes[sid]
    out = svc.renderer.render_by_slices(
        {"tgt": {"extrinsics": d["poses"][0, -1:], "intrinsics": d["intr"][0, -1:],
                 "near_fars": d["near_fars"][0, -1:]}, "ref": sc["ref"]},
        sc["tables"], H, W)
    return out["rgb"].reshape(H, W, 3).numpy(), out["depth"].reshape(H, W).numpy()


def test_render_matches_jax_server(servers):
    (cj, hj), (cp, hp) = _both(servers, "GET", "/healthz")
    assert cj == cp == 200 and hj["backend"] == hp["backend"] == "cpu"
    assert set(hj) == set(hp) == {"ok", "backend", "n_scenes", "uptime_s"}
    sj, sp, d = _add_both(servers, seed=0)
    (cj, rj), (cp, rp) = (_call(servers[0].server_address[1], "POST", "/render",
                                _target(sj, d)),
                          _call(servers[1].server_address[1], "POST", "/render",
                                _target(sp, d)))
    assert cj == cp == 200, (rj, rp)
    rgb_j, rgb_p = decode_array(rj["rgb"]), decode_array(rp["rgb"])
    dep_j, dep_p = decode_array(rj["depth"]), decode_array(rp["depth"])
    assert rgb_p.shape == rgb_j.shape == (H, W, 3) and rgb_p.dtype == np.float32
    assert dep_p.shape == dep_j.shape == (H, W) and dep_p.dtype == np.float32
    assert np.isfinite(rgb_p).all() and np.isfinite(dep_p).all()
    psnr = _psnr(rgb_p, rgb_j)
    assert psnr >= RGB_PSNR_DB, f"agreement PSNR {psnr:.1f} dB < {RGB_PSNR_DB}"
    depth_err = float(np.abs(dep_p - dep_j).max())
    assert depth_err <= DEPTH_TOL, f"depth max|d| {depth_err:.3e} > {DEPTH_TOL}"
    assert float(rgb_j.std()) > 1e-3                        # not a flat image


@pytest.mark.parametrize("precision", ["tiny_default", "test_yaml"])
def test_http_render_equals_direct(servers, precision):
    """The served float32 render is the direct render bit for bit; the
    uint8 one is its quantisation. With configs/test.yaml's precision the
    render takes the block path (pose_prep, Kernels D and E's plain twins
    on the CPU)."""
    if precision == "tiny_default":
        httpd, t = servers[1], None
    else:
        cfg = _tiny_cfg(dtu_eval_config().precision)
        httpd = serve(cfg, servers[2], port=0, max_scenes=2, device="cpu")
        t = _start(httpd)
    try:
        port, svc = httpd.server_address[1], httpd.service
        payload, d = _scene(seed=4)
        code, resp = _call(port, "POST", "/scenes", payload)
        assert code == 200, resp
        sid = resp["scene_id"]
        code, resp = _call(port, "POST", "/render", _target(sid, d))
        assert code == 200, resp
        rgb, depth = decode_array(resp["rgb"]), decode_array(resp["depth"])
        want_rgb, want_depth = _direct(svc, sid, d)
        np.testing.assert_array_equal(rgb, want_rgb)
        np.testing.assert_array_equal(depth, want_depth)
        if precision == "test_yaml":
            route = svc.renderer.last_route
            assert route["block_ut"] is not None and route["color_ut"] is not None, route
        assert set(svc.last_timings) == {"render_s", "pose_prep_s"}
        code, resp = _call(port, "POST", "/render", _target(sid, d, "uint8"))
        assert code == 200
        rgb8 = decode_array(resp["rgb"])
        assert rgb8.dtype == np.uint8
        np.testing.assert_array_equal(rgb8, np.clip(rgb * 255.0 + 0.5, 0, 255)
                                      .astype(np.uint8))
    finally:
        if t is not None:
            _stop(httpd, t)


def test_errors_match_jax_server(servers):
    """LRU eviction, an unknown scene, bad payloads, DELETE twice, an
    unknown mode, a frame count the interpolated path cannot give and
    unknown routes: the JAX server's codes and texts (the scene ids of the
    two servers put in each other's place)."""
    ids = [_add_both(servers, seed=s)[:2] for s in (1, 2, 3)]     # cap 2: first evicted
    assert ids[0][1] not in servers[1].service.scenes
    assert len(servers[1].service.scenes) == 2
    _, d = _scene(0)
    swap = dict(ids)

    def same(method, path, per_server=None, raw=None, code=None):
        """One request to both (`per_server(i)` builds the body for server
        i); the port's answer must be the JAX server's, ids swapped."""
        got = [_call(s.server_address[1], method, path,
                     per_server(i) if per_server else None, raw)
               for i, s in enumerate(servers[:2])]
        (cj, rj), (cp, rp) = got
        text_j = re.sub(r"scene-\d{6}", lambda m: swap.get(m.group(0), m.group(0)),
                        json.dumps(rj))
        assert (cp, json.dumps(rp)) == (cj, text_j)
        if code is not None:
            assert cp == code, rp
        return rp

    resp = same("POST", "/render", lambda i: _target(ids[0][i], d), code=404)
    assert resp["error"] == f"unknown scene '{ids[0][1]}'"
    same("POST", "/render_path", lambda i: {"scene_id": ids[0][i]}, code=404)
    same("POST", "/render_path", lambda i: {"scene_id": "scene-999999"}, code=404)
    resp = same("POST", "/render", lambda i: {"bogus": 1}, code=400)
    assert resp["error"] == "KeyError: 'scene_id'"
    same("POST", "/scenes", lambda i: {"extrinsics": 1}, code=400)
    same("POST", "/render", raw=b"{not json", code=400)
    resp = same("POST", "/render_path", lambda i: {"scene_id": ids[1][i], "mode": "figure8"},
                code=400)
    assert "figure8" in resp["error"] and resp["error"].startswith("ValueError: ")
    # the interpolated path has V * (n // 3) poses: 6 for 8 frames of 3 cameras,
    # and both servers fail alike on the seventh (ROADMAP Queue 3)
    resp = same("POST", "/render_path", lambda i: {"scene_id": ids[1][i], "n_frames": 8},
                code=400)
    assert resp["error"] == "IndexError: index 6 is out of bounds for axis 1 with size 6"
    same("DELETE", "/scenes/scene-999999", code=404)
    for expect in (200, 404):                               # DELETE twice
        got = [_call(s.server_address[1], "DELETE", f"/scenes/{ids[2][i]}")
               for i, s in enumerate(servers[:2])]
        assert got[0] == got[1] == (expect, {"ok": expect == 200})
    assert ids[2][1] not in servers[1].service.scenes
    resp = same("GET", "/nope", code=404)
    assert resp == {"error": "no route /nope"}
    same("POST", "/nope", lambda i: {}, code=404)
    same("DELETE", "/nope", code=404)


@pytest.mark.parametrize("route", ["interpolate", "spiral_stored", "spiral_request",
                                   "spiral_fallback"])
def test_render_path_matches_jax_server(servers, route):
    """Each trajectory: the interpolated path (6 frames: on each source
    camera and half way to the next), and 3 frames of the spiral around the
    scene's stored c2ws_all, the request's, or (neither given) the source
    cameras. Frames within 1 level of uint8 of the JAX server's, except on
    the image border of a frame that sits on a source camera: there a border
    pixel's samples project onto that source image's border (|grid| within
    4e-7 of 1), and the strict in-frustum mask (-1 < grid < 1) takes the
    last bit of each framework's projection (up to 126 levels apart there)."""
    sj, sp, d = _add_both(servers, seed=7, c2ws_all=route == "spiral_stored")
    req = {"n_frames": 6 if route == "interpolate" else 3}
    if route != "interpolate":
        req["mode"] = "spiral"
    if route == "spiral_request":
        req["c2ws_all"] = encode_array(camera.pose_inverse_legacy_np(d["poses"][0]))
    (cj, rj), (cp, rp) = (_call(s.server_address[1], "POST", "/render_path",
                                dict(req, scene_id=sid))
                          for s, sid in zip(servers[:2], (sj, sp)))
    assert cj == cp == 200, (rj, rp)
    fj, fp = decode_array(rj["frames"]), decode_array(rp["frames"])
    assert fp.shape == fj.shape == (req["n_frames"], H, W, 3) and fp.dtype == np.uint8
    diff = np.abs(fp.astype(np.int16) - fj.astype(np.int16))
    off_camera = diff[1::2] if route == "interpolate" else diff
    assert int(off_camera.max()) <= 1, f"frames differ by {int(off_camera.max())} levels"
    assert int(diff[:, 1:-1, 1:-1].max()) <= 1, "frames differ off the image border"
    assert not np.array_equal(fp[0], fp[1])                 # the camera moves


def test_concurrent_requests_equal_serial(servers):
    """12 renders of 2 scenes from 8 client threads, with health checks
    between them and a short switch interval, each bit-equal to the serial
    render of its scene."""
    port = servers[1].server_address[1]
    scenes = []
    for seed in (11, 12):
        payload, d = _scene(seed)
        code, resp = _call(port, "POST", "/scenes", payload)
        assert code == 200
        scenes.append((resp["scene_id"], d))

    def render(i):
        sid, d = scenes[i % 2]
        return _call(port, "POST", "/render", _target(sid, d))

    serial = [render(i)[1] for i in range(2)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=8) as ex:
            futs = [ex.submit(render, i) for i in range(12)]
            health = [ex.submit(_call, port, "GET", "/healthz") for _ in range(4)]
            results = [f.result(timeout=120) for f in futs]
            assert all(h.result(timeout=120)[0] == 200 for h in health)
    finally:
        sys.setswitchinterval(old)
    for i, (code, resp) in enumerate(results):
        assert code == 200, resp
        for key in ("rgb", "depth"):
            np.testing.assert_array_equal(decode_array(resp[key]),
                                          decode_array(serial[i % 2][key]))


def test_main_builds_the_service(tmp_path, caplog):
    """`--config test --cpu` builds the served model of CONFIGS["test"]
    with its overrides: seeded with --random_init (or with --load=, which
    warns that the weights are random), the weights of a checkpoint with
    --load=PATH; without --cpu and with no CUDA device it exits with an
    error, in-process and as `python -m matchnerf_tpu_torch.serve`."""
    small = ["--config", "test", "--cpu", "--port", "0", "--max_scenes", "3",
             "--encoder.num_transformer_layers=1", "--nerf.sample_intvs=8"]
    httpd = build_server(small + ["--random_init"])
    try:
        svc = httpd.service
        assert svc.health()["backend"] == "cpu" and svc.max_scenes == 3
        assert svc.cfg.encoder.num_transformer_layers == 1 and svc.cfg.nerf.sample_intvs == 8
        assert svc.cfg.precision == dtu_eval_config().precision
        model = svc.renderer.model
        assert all(p.device.type == "cpu" for p in model.parameters())
        ckpt = tmp_path / "w.ckpt"
        torch.save({"model": {k: v * 0.5 for k, v in model.state_dict().items()}}, ckpt)
    finally:
        httpd.server_close()
    httpd = build_server(small + [f"--load={ckpt}"])
    try:
        for k, v in httpd.service.renderer.model.state_dict().items():
            torch.testing.assert_close(v, model.state_dict()[k] * 0.5, rtol=0, atol=0)
    finally:
        httpd.server_close()
    with caplog.at_level("WARNING"):
        build_server(small + ["--load="]).server_close()
    assert "RANDOM weights" in caplog.text
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit, match="no CUDA device"):
        build_server(["--config", "test", "--random_init", "--port", "0"])
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-m", "matchnerf_tpu_torch.serve", "--config",
                           "test", "--random_init", "--port", "0"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr, proc.stderr[-2000:]

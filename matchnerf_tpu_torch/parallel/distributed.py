"""Several processes, one card each (counterpart of
matchnerf_tpu/parallel/distributed.py).

The JAX package runs one program over a global device mesh and lets XLA
emit the collectives; here every rank is a process that owns one card (or
runs on the CPU), and the collectives are `torch.distributed` calls made by
`parallel/mesh.py`, the training step and the renderer.

- `maybe_initialize(cfg, device)` brings up the process group when a cluster
  is configured and returns False (touching nothing of torch.distributed)
  for the default single-process run. Its inputs resolve in the JAX
  function's order and names: `parallel.coordinator_address`,
  `num_processes`, `process_id`, `local_device_ids` and `multihost`, then
  the MATCHNERF_COORDINATOR_ADDRESS, MATCHNERF_NUM_PROCESSES,
  MATCHNERF_PROCESS_ID, MATCHNERF_LOCAL_DEVICE_IDS and MATCHNERF_MULTIHOST
  variables. A coordinator means the rendezvous `tcp://<coordinator>`;
  `multihost: true` without one means `env://` (MASTER_ADDR, MASTER_PORT,
  RANK, WORLD_SIZE, as torchrun sets them), the counterpart of JAX's
  auto-detection.
- Each rank owns one card: `local_device_ids` (one id) when given, else
  `process_id % torch.cuda.device_count()`.
- The backend follows one rule (`choose_backend`), decided from the ranks'
  device identities (host name and card UUID) exchanged through the
  rendezvous store: NCCL where every rank's card is its own, gloo where two
  ranks share a card (NCCL refuses two ranks on one device) and on the CPU.
  The choice is logged and read back with `backend()`. Any failure to
  initialise raises.
- `process_index`, `process_count`, `is_main_process` gate the host's side
  effects (rank 0 alone writes checkpoints, scalars, images, options);
  `broadcast_str` and `broadcast_tree` give every rank rank 0's run name
  and state. Without a process group they return their input.
- `spawn(fn, n_workers, *args)` starts one worker per card on this host
  (start method spawn, the rendezvous on 127.0.0.1): the entries' answer to
  `parallel.data_parallel` asking for several local cards, as one JAX
  process drives every local chip.
"""
from __future__ import annotations

import json
import logging
import os
import socket
from typing import Any, List, Optional

import torch

log = logging.getLogger(__name__)

ENV_KEYS = {"coordinator_address": "MATCHNERF_COORDINATOR_ADDRESS",
            "num_processes": "MATCHNERF_NUM_PROCESSES",
            "process_id": "MATCHNERF_PROCESS_ID",
            "local_device_ids": "MATCHNERF_LOCAL_DEVICE_IDS",
            "multihost": "MATCHNERF_MULTIHOST"}
_IDENT_KEY = "matchnerf/device/{}"


def _cfg_par(cfg):
    par = (cfg.get("parallel") if cfg is not None and hasattr(cfg, "get") else None) or {}
    return par if hasattr(par, "get") else {}


def _field(par, key: str) -> Optional[Any]:
    v = par.get(key)
    if v is None or v == "" or v == []:
        v = os.environ.get(ENV_KEYS[key])
    return None if v in (None, "") else v


def _truthy(v) -> bool:
    return v is not None and str(v).lower() not in ("0", "false", "no", "off")


def cluster_configured(cfg=None) -> bool:
    """A coordinator or `multihost` is set (in the config or the
    environment): `maybe_initialize` will bring up a process group."""
    par = _cfg_par(cfg)
    return _field(par, "coordinator_address") is not None or _truthy(_field(par, "multihost"))


def choose_backend(identities: List[Optional[str]]) -> str:
    """The backend for ranks with these device identities (None: a rank on
    the CPU): NCCL where every rank has a card of its own, else gloo."""
    if not identities or any(i is None for i in identities):
        return "gloo"
    return "nccl" if len(set(identities)) == len(identities) else "gloo"


def _card(par, rank: int) -> int:
    ids = _field(par, "local_device_ids")
    if ids is not None:
        if isinstance(ids, str):
            ids = [int(x) for x in ids.split(",") if x.strip()]
        ids = [int(x) for x in (ids if isinstance(ids, (list, tuple)) else [ids])]
        if len(ids) != 1:
            raise ValueError(f"parallel.local_device_ids {ids}: a rank owns one card")
        return ids[0]
    return rank % torch.cuda.device_count()


def _identity(card: int) -> str:
    """Host name and the card's UUID (its index on the host where torch
    does not report the UUID)."""
    props = torch.cuda.get_device_properties(card)
    uuid = getattr(props, "uuid", None)
    return f"{socket.gethostname()}/{uuid if uuid is not None else f'cuda:{card}'}"


def maybe_initialize(cfg=None, device: str = "cuda") -> bool:
    """Bring up the process group when a cluster is configured (see the
    module docstring); False, and nothing touched, otherwise. Idempotent.
    device "cpu" runs the rank on the CPU (gloo); any other device needs a
    CUDA card for every rank."""
    if is_initialized():
        return True
    par = _cfg_par(cfg)
    coord = _field(par, "coordinator_address")
    if coord is None and not _truthy(_field(par, "multihost")):
        return False
    if coord is not None:
        nproc, pid = _field(par, "num_processes"), _field(par, "process_id")
        if nproc is None or pid is None:
            raise ValueError("parallel.coordinator_address needs num_processes and process_id "
                             "(or MATCHNERF_NUM_PROCESSES and MATCHNERF_PROCESS_ID)")
        url, rank, world = f"tcp://{coord}", int(pid), int(nproc)
    else:
        url, rank, world = "env://", -1, -1
    store, rank, world = next(torch.distributed.rendezvous(url, rank, world))

    on_cpu = torch.device(device).type == "cpu"
    if on_cpu:
        dev, ident = torch.device("cpu"), None
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device (run the ranks with --cpu "
                               "on a machine without cards)")
        card = _card(par, rank)
        torch.cuda.set_device(card)
        dev, ident = torch.device("cuda", card), _identity(card)
    store.set(_IDENT_KEY.format(rank), "" if ident is None else ident)
    identities = [store.get(_IDENT_KEY.format(r)).decode() or None for r in range(world)]
    backend = choose_backend(identities)
    torch.distributed.init_process_group(backend, store=store, rank=rank, world_size=world)
    shared = len(set(identities)) < len(identities)
    log.info("torch.distributed: rank %d of %d on %s, backend %s (%s)", rank, world, dev,
             backend, "ranks on the CPU" if None in identities else
             "ranks share a card" if shared else "one card per rank")
    return True


def shutdown():
    """Destroy the process group (tests and chip_smoke bring up several in
    one process)."""
    if is_initialized():
        torch.distributed.destroy_process_group()


def is_initialized() -> bool:
    """A default process group exists (brought up here or by the caller)."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def backend() -> Optional[str]:
    """"nccl" or "gloo" once initialised, else None."""
    return torch.distributed.get_backend() if is_initialized() else None


def process_index() -> int:
    return torch.distributed.get_rank() if is_initialized() else 0


def process_count() -> int:
    return torch.distributed.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def comm_device() -> torch.device:
    """Where this rank's collectives take host-side values: its card under
    NCCL, the CPU under gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast_bytes(raw: bytes) -> bytes:
    dev = comm_device()
    n = torch.tensor([len(raw)], dtype=torch.int64, device=dev)
    torch.distributed.broadcast(n, 0)
    buf = (torch.tensor(list(raw), dtype=torch.uint8, device=dev) if process_index() == 0
           else torch.empty(int(n), dtype=torch.uint8, device=dev))
    if int(n):
        torch.distributed.broadcast(buf, 0)
    return bytes(buf.cpu().tolist())


def broadcast_str(s: str) -> str:
    """Every rank adopts rank 0's string (run names carry a timestamp or a
    random suffix that differs per process)."""
    if process_count() == 1:
        return s
    return _broadcast_bytes(s.encode("utf-8")).decode("utf-8")


def _spec(tree, leaves: List[torch.Tensor]):
    """A JSON-able description of `tree` with its scalars in it; tensors
    are appended to `leaves` and described by shape, dtype and device type."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return {"t": [list(tree.shape), str(tree.dtype).replace("torch.", ""),
                      tree.device.type]}
    if isinstance(tree, dict):
        return {"d": [[k, type(k).__name__, _spec(v, leaves)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        return {"l" if isinstance(tree, list) else "u": [_spec(v, leaves) for v in tree]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"v": tree}
    raise TypeError(f"broadcast_tree: unsupported leaf {type(tree)}")


def _build(spec, leaves):
    if "t" in spec:
        return leaves.pop(0)
    if "d" in spec:
        keys = {"int": int, "str": str}
        return {keys[kt](k): _build(v, leaves) for k, kt, v in spec["d"]}
    if "l" in spec or "u" in spec:
        items = [_build(v, leaves) for v in spec.get("l", spec.get("u"))]
        return items if "l" in spec else tuple(items)
    return spec["v"]


def broadcast_tree(tree):
    """Every rank adopts rank 0's tree of tensors and scalars (dicts with
    str or int keys, lists, tuples; a model's and an optimizer's state). The
    structure travels from rank 0 (a rank that could not restore a
    checkpoint may hold an optimizer state of another shape); the tensors
    go per dtype in one flat buffer each and land on the device type rank 0
    holds them on (a CUDA tensor on this rank's card)."""
    if process_count() == 1:
        return tree
    leaves: List[torch.Tensor] = []
    spec = _spec(tree, leaves) if process_index() == 0 else None
    spec = json.loads(_broadcast_bytes(json.dumps(spec).encode("utf-8")))
    dev = comm_device()
    if process_index() != 0:
        leaves = []

        def collect(s):
            if "t" in s:
                shape, dtype, kind = s["t"]
                where = (torch.device("cuda", torch.cuda.current_device()) if kind == "cuda"
                         else torch.device("cpu"))
                leaves.append(torch.empty(shape, dtype=getattr(torch, dtype), device=where))
            for key in ("d", "l", "u"):
                for item in s.get(key, []):
                    collect(item[2] if key == "d" else item)

        collect(spec)
    by_dtype = {}
    for i, t in enumerate(leaves):
        by_dtype.setdefault(t.dtype, []).append(i)
    out = list(leaves)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([leaves[i].detach().reshape(-1).to(dev) for i in idx])
        torch.distributed.broadcast(flat, 0)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].reshape(leaves[i].shape).to(leaves[i].device).clone()
            off += n
    return _build(spec, out)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_workers(cfg) -> int:
    """How many workers an entry on this host spawns: `parallel.data_parallel`
    (-1 or 0: all) of the visible cards, when no cluster is configured;
    1 (no spawn) otherwise."""
    if cluster_configured(cfg) or not torch.cuda.is_available():
        return 1
    avail = torch.cuda.device_count()
    n = int(_cfg_par(cfg).get("data_parallel", -1) or -1)
    return avail if n <= 0 else min(n, avail)


def _worker(index: int, fn, n_workers: int, address: str, args):
    os.environ[ENV_KEYS["coordinator_address"]] = address
    os.environ[ENV_KEYS["num_processes"]] = str(n_workers)
    os.environ[ENV_KEYS["process_id"]] = str(index)
    fn(*args)


def spawn(fn, n_workers: int, *args):
    """Run fn(*args) in n_workers processes started with the spawn method,
    worker i as rank i of a rendezvous on 127.0.0.1 (MATCHNERF_* set in its
    environment). A worker that fails ends the others and raises here."""
    import torch.multiprocessing as mp

    address = f"127.0.0.1:{free_port()}"
    log.info("spawning %d workers, rendezvous tcp://%s", n_workers, address)
    mp.start_processes(_worker, args=(fn, n_workers, address, args), nprocs=n_workers,
                       join=True, start_method="spawn")

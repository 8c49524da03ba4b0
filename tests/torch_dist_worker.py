"""Ranks of a ``torch.distributed`` process group for the port's
multi-process tests (this file holds no tests, and imports nothing of JAX:
it runs in the spawned ranks).

``launch(payload, world, workdir)`` writes ``payload`` (a dict of cases,
tensors and config dumps) to ``workdir``, starts ``world`` processes of
this script, each of which joins a gloo group on a free localhost port
(``init_process_group`` timeout 60 s), runs every case of the payload in
order and writes its results; the launcher kills every rank and fails
where they do not end within ``timeout`` seconds, and returns each rank's
results, in rank order. On ``device="cuda"`` every rank uses card 0, or
with ``one_card_each`` rank r card r (``LOCAL_RANK``).

A case is a dict with a ``kind``:

* "steps": the configured model (``cfg`` dump; ``state_dict``, or the
  model's own seeded init where it is None) stepped on the rank's blocks
  of the global ``batches`` by the sharded step of the mesh ``axes`` /
  ``shape`` ("plain", "csc" or "multi" in ``step``); returns the metrics
  of every step and a digest of the full parameters and buffers after
  every step, and from rank 0 the final full trainable parameters and
  buffers (under a split also every rank's own blocks and the gathered
  momentum traces); optionally saves a checkpoint into ``save_dir`` or
  first loads one from ``load_dir``; with ``plain_too`` also the metrics
  and digests of the plain step of one process on the global batches,
  from the same init;
* "rpn": the same over :func:`rpn_toy`;
* "gather": a VOC evaluator fed the rank's shard of ``detections``, then
  ``gather_and_evaluate``;
* "main": ``train_net.main`` with ``argv``, the process group initialised
  from torchrun's environment variables, VOC directories registered
  first.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

INIT_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(payload: dict, world: int, workdir, timeout: float = 240.0,
           device: str = "cpu", one_card_each: bool = False):
    """Run the payload's cases on ``world`` ranks; returns their results
    in rank order (see the module docstring)."""
    return finish(start(payload, world, workdir, device, one_card_each),
                  timeout)


def start(payload: dict, world: int, workdir, device: str = "cpu",
          one_card_each: bool = False):
    """Start the ranks of :func:`launch` and return at once (the caller
    may work meanwhile); :func:`finish` waits for them."""
    import torch

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(payload, workdir / "payload.pt")
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank if one_card_each else 0),
                   MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(workdir), device],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return workdir, procs, time.monotonic()


def finish(handle, timeout: float = 240.0):
    """Wait for the ranks of :func:`start` (``timeout`` seconds from their
    start, then every rank is killed and this fails); their results in
    rank order."""
    import torch

    workdir, procs, started = handle
    world = len(procs)
    deadline = started + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        raise AssertionError(f"ranks did not end within {timeout} s: "
                             + _tails(workdir, world))
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} failed: " + _tails(workdir, world))
    out = [torch.load(workdir / f"result{r}.pt", weights_only=False)
           for r in range(world)]
    for f in [workdir / "payload.pt"] + [workdir / f"result{r}.pt"
                                         for r in range(world)]:
        f.unlink()
    return out


def _tails(workdir: Path, world: int) -> str:
    out = []
    for r in range(world):
        f = workdir / f"rank{r}.log"
        if f.exists():
            out.append(f"--- rank {r}\n" + f.read_text()[-3000:])
    return "\n".join(out)


# ------------------------------------------------------------------ in rank
def _cfg(dump: str):
    import tempfile

    from drn_wsod_torch.config import get_cfg

    with tempfile.NamedTemporaryFile("w", suffix=".yaml",
                                     delete=False) as f:
        f.write(dump)
    cfg = get_cfg()
    cfg.merge_from_file(f.name)
    os.unlink(f.name)
    return cfg


def _host(sd):
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def _digest(sd) -> str:
    """A digest of every tensor's bytes (bit-equality across ranks)."""
    import torch

    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rpn_toy(device="cpu"):
    """A one-level RPN over the 4x average-pooled image (3 anchors a cell
    at stride 4): ``model(batch, train, generator)`` returns the batch's
    ``loss_rpn_cls`` / ``loss_rpn_loc`` (``rpn_batch_losses``, 32 anchors
    sampled an image)."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from drn_wsod_torch.models import proposal_generator as pg

    class _RPNToy(nn.Module):
        def __init__(self):
            super().__init__()
            self.rpn_head = pg.StandardRPNHead(3, 3, conv_dim=8)

        def init_weights(self, generator):
            self.rpn_head.init_weights(generator)

        def forward(self, batch, *, train=True, generator=None, **_):
            x = F.avg_pool2d(batch.image.permute(0, 3, 1, 2) / 255.0, 4)
            obj, deltas = self.rpn_head([x])[0]
            B, A, H, W = obj.shape
            obj = obj.permute(0, 2, 3, 1).reshape(B, -1)
            deltas = deltas.reshape(B, A, 4, H, W).permute(
                0, 3, 4, 1, 2).reshape(B, -1, 4)
            anchors = pg.generate_anchors((H, W), 4, (16.0,),
                                          (0.5, 1.0, 2.0), x.device)
            lo, ll = pg.rpn_batch_losses(
                anchors, obj, deltas, batch.gt_boxes, batch.gt_valid,
                generator, batch_size=32)
            return {"loss_rpn_cls": lo, "loss_rpn_loc": ll}

    return _RPNToy().to(device)


def _run_steps(case, device):
    import torch

    import drn_wsod_torch as D
    from drn_wsod_torch.checkpoint import Checkpointer
    from drn_wsod_torch.parallel import mesh as M
    from drn_wsod_torch.parallel import multihost
    from drn_wsod_torch.parallel import train_parallel as TP
    from drn_wsod_torch.structures.batch import WSODBatch

    cfg = _cfg(case["cfg"])
    if case["kind"] == "rpn":
        model = rpn_toy(device)
        model.init_weights(torch.Generator(device=device).manual_seed(0))
    else:
        model = D.build_model(cfg, device=device)
    if case.get("state_dict") is not None:
        model.load_state_dict(case["state_dict"], strict=True)
    tx = D.build_optimizer(cfg, model)
    state = D.create_train_state(model, tx)
    mesh = M.create_mesh(case["axes"], case["shape"])
    kind = case.get("step", "plain")
    if kind == "csc":
        step = TP.make_sharded_csc_train_step(model, tx, mesh, state=state,
                                              tau=case.get("tau", 0.7))
    elif kind == "multi":
        step = TP.make_sharded_multi_train_step(model, tx, mesh, state=state)
    else:
        step = TP.make_sharded_train_step(model, tx, mesh, state=state)
    if case.get("load_dir"):
        Checkpointer(case["load_dir"]).load(state)
    batches = [WSODBatch(**b).to(device) for b in case["batches"]]
    metrics, digests = [], []
    if kind == "multi":
        k = case["k"]
        for i in range(0, len(batches), k):
            chunk = M.stack_and_shard_batches(batches[i:i + k], mesh)
            state, m = step(state, chunk, case.get("seed", 0))
            for j in range(len(chunk)):
                metrics.append({n: float(v[j]) for n, v in m.items()})
            digests.append(_digest(M.full_state_dict(model)))
    else:
        for b in batches:
            state, m = step(state, M.shard_batch(b, mesh),
                            case.get("seed", 0))
            metrics.append({n: float(v) for n, v in m.items()})
            digests.append(_digest(M.full_state_dict(model)))
    if case.get("save_dir"):
        Checkpointer(case["save_dir"]).save(state, state.step)
    out = {"metrics": metrics, "digests": digests}
    full = M.full_state_dict(model)
    trace = M.full_opt_state(model, state.opt_state)["trace"]
    if mesh.model_size > 1:
        out["split"] = M.split_dims(model)
        out["local"] = {n: p.detach().cpu().clone()
                        for n, p in model.named_parameters()
                        if n in out["split"]}
        out["opt_trace"] = {n: v.cpu().clone() for n, v in trace.items()
                            if v is not None}
    if multihost.get_rank() == 0:
        frozen = {n for n, p in model.named_parameters()
                  if not p.requires_grad}
        out["state_dict"] = _host({n: v for n, v in full.items()
                                   if n not in frozen})
    if case.get("plain_too"):
        model = D.build_model(cfg, device=device)
        tx = D.build_optimizer(cfg, model)
        state = D.create_train_state(model, tx)
        plain = D.make_train_step(model, tx)
        out["plain_metrics"], out["plain_digests"] = [], []
        for b in batches:
            state, m = plain(state, b, case.get("seed", 0))
            out["plain_metrics"].append({n: float(v) for n, v in m.items()})
            out["plain_digests"].append(_digest(model.state_dict()))
    return out


def _run_gather(case):
    from drn_wsod_torch.evaluation import (PascalVOCDetectionEvaluator,
                                           gather_and_evaluate)
    from drn_wsod_torch.parallel import multihost

    ev = PascalVOCDetectionEvaluator(case["classes"], case["gt"])
    ev.reset()
    rank, world = multihost.get_rank(), multihost.get_world_size()
    for image_id, det in list(case["detections"].items())[rank::world]:
        ev.process_single(image_id, *det)
    return gather_and_evaluate(ev)


def _run_main(case, device):
    import logging

    from drn_wsod_torch.data.datasets import voc as pvoc
    from drn_wsod_torch.parallel import multihost
    from drn_wsod_torch.tools import train_net

    for name, d, split in case["register"]:
        pvoc.register_pascal_voc(name, d, split, 2007)
    args = train_net.argument_parser().parse_args(case["argv"])
    out = train_net.main(args, device=device)
    logging.shutdown()
    return {"results": out, "rank": multihost.get_rank()}


def _rank_main(workdir: str, device: str):
    import torch
    import torch.distributed as dist

    from drn_wsod_torch.parallel import multihost

    torch.set_num_threads(1)
    payload = torch.load(Path(workdir) / "payload.pt", weights_only=False)
    if device.startswith("cuda"):
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        # as the tests' ``cuda`` fixture: float32 stays float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if int(os.environ["WORLD_SIZE"]) > 1:
        multihost.init_process_group(backend=payload.get("backend", "gloo"),
                                     timeout_s=INIT_TIMEOUT_S)
    else:       # a group of one rank (NCCL at world size 1), from the env
        import datetime

        dist.init_process_group(
            backend=payload.get("backend", "gloo"), init_method="env://",
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    results = {}
    for name, case in payload["cases"].items():
        if case["kind"] in ("steps", "rpn"):
            results[name] = _run_steps(case, device)
        elif case["kind"] == "gather":
            results[name] = _run_gather(case)
        elif case["kind"] == "main":
            results[name] = _run_main(case, device)
        else:
            raise ValueError(case["kind"])
    rank = multihost.get_rank()
    torch.save(results, Path(workdir) / f"result{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])

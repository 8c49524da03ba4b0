"""Trainer hooks (counterpart of ``drn_wsod_tpu/engine/hooks.py``): the
four-phase protocol ``before_train`` / ``before_step`` / ``after_step`` /
``after_train``, with ``IterationTimer``, ``PeriodicWriter``,
``PeriodicCheckpointer``, ``ProfilerHook``, ``PreciseBNHook``, ``EvalHook``
and ``PGTVisualization``.

Over several processes ``tools/train_net.py:do_train`` gives the writers to
rank 0 alone, as the JAX package does; the checkpointer, PreciseBN and
evaluation hooks run on every rank (the checkpoint and the evaluation are
collective, and rank 0 alone writes or evaluates); so does
``PGTVisualization``'s forward (collective under a split DAN), and rank 0
alone writes its images.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

from ..parallel.mesh import broadcast_buffers
from ..utils import tracing
from .events import get_event_storage

logger = logging.getLogger(__name__)


class HookBase:
    trainer = None  # set by Trainer.register_hooks

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class IterationTimer(HookBase):
    """Records the seconds per iteration as ``time``, after
    ``warmup_iter`` iterations: the trainer's fenced time per step
    (``trainer.last_chunk_step_time``, set where metrics are read back),
    never the wall time between two steps, which measures only their issue.
    Logs the total and the overall speed at the end."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._start_time = time.perf_counter()

    def before_train(self):
        self._start_time = time.perf_counter()

    def after_train(self):
        total = time.perf_counter() - self._start_time
        logger.info(f"Total training time: {total:.2f}s")
        vals = [v for v, _ in get_event_storage().history("time").values()]
        if vals:
            logger.info(
                f"Overall training speed: {len(vals)} iterations in "
                f"{sum(vals):.1f}s ({sum(vals) / len(vals):.4f} s / it)")

    def after_step(self):
        storage = get_event_storage()
        if self.trainer.iter - self.trainer.start_iter < self._warmup_iter:
            return
        chunk = getattr(self.trainer, "last_chunk_step_time", None)
        if chunk is not None:
            storage.put_scalar("time", chunk, smoothing_hint=True)


class PeriodicWriter(HookBase):
    """Runs the writers every ``period`` iterations, at the last one and
    after training (then closes them)."""

    def __init__(self, writers, period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        if (self.trainer.iter + 1) % self._period == 0 or (
                self.trainer.iter == self.trainer.max_iter - 1):
            for w in self._writers:
                w.write(get_event_storage())

    def after_train(self):
        for w in self._writers:
            w.write(get_event_storage())
            w.close()


class PeriodicCheckpointer(HookBase):
    """Saves the train state every ``period`` iterations and at the last,
    under the number of steps taken."""

    def __init__(self, checkpointer, period: int):
        self._checkpointer = checkpointer
        self._period = period

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or it == self.trainer.max_iter - 1:
            self._checkpointer.save(self.trainer.state, it + 1)


class ProfilerHook(HookBase):
    """Traces ``num_iters`` iterations from ``start_iter`` with
    ``torch.profiler`` (CPU, and CUDA where the card is used) and the
    program's own spans (``utils/tracing.py``, on for the same window),
    and writes one Chrome trace to ``output_dir/trace_iter{start}.json``:
    the spans lie on their threads over the operators and kernels."""

    def __init__(self, output_dir: str, start_iter: int = 10,
                 num_iters: int = 5):
        self._dir = output_dir
        self._start = start_iter
        self._stop = start_iter + num_iters
        self._prof = None

    def before_step(self):
        if self.trainer.iter == self._start and self._prof is None:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            tracing.enable()

    def after_step(self):
        if self.trainer.iter + 1 >= self._stop and self._prof is not None:
            self._finish()

    def after_train(self):
        if self._prof is not None:
            self._finish()

    def _finish(self):
        prof, self._prof = self._prof, None
        tracing.disable()
        prof.__exit__(None, None, None)
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, f"trace_iter{self._start}.json")
        prof.export_chrome_trace(path)
        tracing.merge_chrome_trace(path, *tracing.drain())
        logger.info(f"Saved profiler trace to {path}")


class PreciseBNHook(HookBase):
    """Recompute the BatchNorm statistics of the trainer's model
    (``precise_bn.update_bn_stats``) over ``num_iters`` batches of a fresh
    ``data_iter_fn()`` every ``period`` iterations but the last, and after
    training. A model without BatchNorm is left as it is.

    Over several processes every rank runs it on its own batches (a split
    DAN's forward is collective) and then takes rank 0's buffers, so that
    the replicas stay bit-equal: the JAX package runs it on the main
    process alone, which would leave the replicas' statistics apart."""

    def __init__(self, period: int, data_iter_fn: Callable,
                 num_iters: int = 200):
        self._period = max(int(period), 1)
        self._data_iter_fn = data_iter_fn
        self._num_iters = num_iters

    def _run(self):
        from .precise_bn import update_bn_stats

        batches = (self.trainer.to_device(b) for b in self._data_iter_fn())
        update_bn_stats(self.trainer.state.model, batches, self._num_iters)
        broadcast_buffers(self.trainer.state.model)

    def after_step(self):
        if (self.trainer.iter + 1) % self._period == 0 and \
                self.trainer.iter != self.trainer.max_iter - 1:
            self._run()

    def after_train(self):
        self._run()


class EvalHook(HookBase):
    """Runs ``eval_fn`` every ``period`` iterations (not at the last) and
    after training when the last iteration was reached; puts its numeric
    results into the storage under "/"-joined keys."""

    def __init__(self, period: int, eval_fn: Callable[[], Optional[dict]]):
        self._period = period
        self._fn = eval_fn

    def _do_eval(self):
        results = self._fn()
        if not results:
            return
        flat = {}

        def _flatten(d, prefix=""):
            for k, v in d.items():
                key = f"{prefix}{k}"
                if isinstance(v, dict):
                    _flatten(v, key + "/")
                elif isinstance(v, (int, float)):
                    flat[key] = float(v)

        _flatten(results)
        get_event_storage().put_scalars(smoothing_hint=False, **flat)

    def after_step(self):
        if self._period > 0 and (self.trainer.iter + 1) % self._period == 0 \
                and self.trainer.iter != self.trainer.max_iter - 1:
            self._do_eval()

    def after_train(self):
        if self.trainer.iter >= self.trainer.max_iter - 1:
            self._do_eval()


class PGTVisualization(HookBase):
    """Every ``period`` iterations, dump the pseudo-GT boxes OICR mines on
    the last training batch (the JAX package's hook, after the reference's
    ``_vis_pgt``): a pass of ``model.proposal_scores`` without autograd on
    ``trainer.last_batch``, ``heads/oicr.py:mine_pgt`` on its WSDDN
    evidence, then the first ``max_images`` images with their boxes as
    PNGs under ``output_dir/pgt_vis`` (``utils/visualizer.py``, no Pillow)
    and ``put_image`` for the TensorBoard writer."""

    def __init__(self, period: int, model, output_dir: str,
                 class_names=None, max_images: int = 2):
        self._period = max(int(period), 1)
        self._model = model
        self._out = output_dir
        self._names = class_names
        self._max = max_images

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period or self.trainer.last_batch is None:
            return
        import numpy as np
        import torch

        from ..models.heads.oicr import mine_pgt
        from ..models.heads.wsddn import image_probs
        from ..parallel import multihost
        from ..utils.visualizer import save_pgt_visualization

        batch = self.trainer.last_batch
        with torch.no_grad():
            scores = self._model.proposal_scores(batch)
            pgt = mine_pgt(scores, batch.proposals, batch.proposal_mask,
                           batch.labels, image_probs(scores))
        if not multihost.is_main_process():
            return
        boxes, valid = pgt.boxes.cpu().numpy(), pgt.valid.cpu().numpy()
        imgs = batch.image.cpu().numpy()
        storage = self.trainer.storage
        for i in range(min(imgs.shape[0], self._max)):
            img = np.clip(imgs[i], 0, 255).astype(np.uint8)
            save_pgt_visualization(
                img, boxes[i], valid[i], self._names,
                os.path.join(self._out, "pgt_vis"),
                prefix=f"iter{it + 1:07d}_im{i}", suffix="")
            if storage is not None:
                storage.put_image(f"pgt/im{i}", img[:, :, ::-1])

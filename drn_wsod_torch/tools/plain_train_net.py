"""A minimal explicit training loop (counterpart of
``tools/plain_train_net.py``): what ``tools/train_net.py`` does, written
against the library directly, without the ``Trainer`` and its hooks, as
a starting point for custom training logic.

    python -m drn_wsod_torch.tools.plain_train_net --config-file CONFIG \\
        [--resume] [KEY VALUE ...]

Build the model, the optimizer and the train state; resume from
``OUTPUT_DIR/checkpoints`` (with ``--resume``) or load ``MODEL.WEIGHTS``;
the sharded step over ``PARALLEL.MESH_AXES`` / ``MESH_SHAPE``
(``parallel/train_parallel.py``; one rank without a process group); then
for each iteration pull the rank's batch, move it to the card and step
with the seed ``SEED``. Every 20 iterations and at the last, the loss is
read back (the fence) and logged with the learning rate and s/it; a
checkpoint is saved every ``SOLVER.CHECKPOINT_PERIOD`` and at the last.
Runs on the CUDA device unless ``main`` is given another one.
"""

from __future__ import annotations

import logging
import os
import time

logger = logging.getLogger("drn_wsod_torch")


def main(args, device=None):
    """Train; returns the final train state."""
    from ..checkpoint import Checkpointer
    from ..config import get_cfg
    from ..data import DatasetMapper, build_detection_train_loader
    from ..data.datasets.voc import register_all_pascal_voc
    from ..device import resolve_device
    from ..engine import create_train_state
    from ..engine.defaults import default_setup
    from ..models import build_model
    from ..parallel.mesh import create_mesh
    from ..parallel.train_parallel import make_sharded_train_step
    from ..solver import build_optimizer
    from ..solver.build import build_lr_schedule

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    default_setup(cfg, args)
    register_all_pascal_voc(os.environ.get("DETECTRON2_DATASETS", "datasets"))

    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    tx = build_optimizer(cfg, model)
    state = create_train_state(model, tx)
    checkpointer = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "checkpoints"))
    state, start_iter = checkpointer.resume_or_load(
        state, cfg.MODEL.WEIGHTS, resume=args.resume)

    mesh = create_mesh(tuple(cfg.PARALLEL.MESH_AXES),
                       tuple(cfg.PARALLEL.MESH_SHAPE))
    step = make_sharded_train_step(model, tx, mesh, state=state)
    seed = max(cfg.SEED, 0)
    lr_schedule = build_lr_schedule(cfg)

    loader = build_detection_train_loader(
        cfg, DatasetMapper(cfg, is_train=True), process_index=mesh.data_rank,
        process_count=mesh.data_size)
    data_iter = iter(loader)

    max_iter = cfg.SOLVER.MAX_ITER
    t0 = time.perf_counter()
    for it in range(start_iter, max_iter):
        batch = next(data_iter).to(dev)
        state, metrics = step(state, batch, seed)
        if (it + 1) % 20 == 0 or it + 1 == max_iter:
            # reading the loss back fences the queued steps
            loss = float(metrics["total_loss"])
            dt = (time.perf_counter() - t0) / (it + 1 - start_iter)
            logger.info("iter %d/%d  total_loss %.4f  lr %.5f  %.3f s/it",
                        it + 1, max_iter, loss, lr_schedule(it), dt)
        if (it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or \
                it + 1 == max_iter:
            checkpointer.save(state, it + 1)
    return state


if __name__ == "__main__":
    from ..engine.defaults import default_argument_parser

    main(default_argument_parser().parse_args())

"""Training CLI of the PyTorch port (the counterpart of ``scripts/train.py``).

    python -m foundationstereo_torch.train.cli --config configs/train/stereo_v1.json \\
        --workspace workspace/run1 [--num_iterations N] [--batch_size B] \\
        [--checkpoint latest|none|STEP] [--device cuda|cpu] [--n_devices N]

The same flags, ``--override`` paths and JSON config as the JAX CLI: the
data pipeline prefetches on host threads, each batch is padded to /32 on
the host and moved to the device (pinned, non-blocking), the trainer takes
one step, and each step's metrics go to ``metrics.jsonl`` with the phase
times ``t_dispatch`` (the step: forward, backward and update, up to its one
synchronisation), ``t_get`` (waiting on the pipeline), ``t_data`` (padding
and the copy to the device) and ``t_fence`` (fetching the metrics).
Checkpoints (``train/checkpoints.py``) go to ``<workspace>/checkpoints`` every
``--save_every`` steps and at the end; a run resumes from ``latest`` by
default. A step's dropout key comes from ``(--seed, step)``.

Several devices, as the JAX CLI's ``--n_devices``: 0 (the default) trains
on every visible card (one process with ``--device cpu``), N > 1 on N ranks,
one process each (``torch.distributed``; rank r on card r over ``nccl``, or
on the CPU over ``gloo``), laid out as the JAX CLI's ``make_mesh(N)`` lays
out its devices: ``spatial`` takes the largest power of two <= 4 that
divides N and ``data`` the rest (``parallel.mesh.factor``; so
``--n_devices 2`` trains each sample across two ranks, split along image
width, and ``--n_devices 8`` is data 2 x spatial 4). Where a launcher set
``RANK`` and ``WORLD_SIZE`` (several hosts) the process joins them;
otherwise the CLI spawns N local ranks on a free local port. Ranks that
share a card need ``--dist_backend gloo`` (NCCL refuses two ranks on one
device: the CLI raises rather than switch). ``--batch_size`` is the global
batch and ``data`` must divide it: the first rank of each data index draws
``batch_size / data`` samples from its pipeline, sampling from ``--seed`` +
its data index, and hands them to the other ranks of its ``spatial`` group.
The step is the one-process step on the global batch
(``train/trainer.py``). Rank 0 alone writes ``metrics.jsonl`` (the global
batch's means), the visualisations (from one unpartitioned forward) and the
checkpoints; every rank restores the same one, and every ``--log_every``
steps the ranks' parameters, batch stats and EMA are checked bit for bit
against rank 0's.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="FoundationStereo training on PyTorch")
    ap.add_argument("--config", required=True)
    ap.add_argument("--workspace", default="workspace/run")
    ap.add_argument("--num_iterations", type=int, default=200_000)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--gradient_accumulation_steps", type=int, default=1)
    ap.add_argument("--checkpoint", default="latest", help="'latest', a step number, or 'none'")
    ap.add_argument("--save_every", type=int, default=1000)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ema", type=int, default=1)
    ap.add_argument("--n_devices", type=int, default=0,
                    help="ranks: 0 = every visible card (1 with --device cpu), as a data x spatial "
                         "mesh (spatial: the largest power of two <= 4 dividing N); --batch_size "
                         "is the global batch, split evenly over data")
    ap.add_argument("--dist_backend", default=None,
                    help="nccl (the default on cards: one card per rank) or gloo (the CPU's; "
                         "ranks that share a card)")
    ap.add_argument("--mlflow", type=int, default=0)
    ap.add_argument("--vis_every", type=int, default=0,
                    help="dump left|GT|prediction panels every N steps")
    ap.add_argument("--profile_steps", type=str, default="",
                    help="'start,stop' step range to trace with torch.profiler")
    ap.add_argument("--override", action="append", default=[],
                    help="dot-path config override, e.g. model.vit_size=vits "
                         "or data.datasets.0.path=/tmp/data (JSON values)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def apply_overrides(config: dict, overrides: list[str]) -> dict:
    for ov in overrides:
        path, _, raw = ov.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = config
        keys = path.split(".")
        for k in keys[:-1]:
            node = node[int(k)] if isinstance(node, list) else node[k]
        last = keys[-1]
        if isinstance(node, list):
            node[int(last)] = value
        else:
            node[last] = value
    return config


def host_batch(raw: dict, loss_cfg: dict) -> dict:
    """A pipeline batch as the trainer's arrays: images back to 0-255 and
    padded to /32 (edge mode), disparity and mask zero-padded, label
    indices (the step's dropout ``rng`` is added by the caller)."""
    from foundationstereo_torch.ops.pad import InputPadder
    from foundationstereo_torch.train.trainer import make_label_index

    left = (raw["left_image"] * np.float32(255.0)).astype(np.float32)
    right = (raw["right_image"] * np.float32(255.0)).astype(np.float32)
    padder = InputPadder(left.shape, divis_by=32)
    l, _, t, _ = padder.pads
    left, right = padder.pad_np(left, right)
    h, w = left.shape[1], left.shape[2]
    gt = np.zeros((left.shape[0], h, w), np.float32)
    m = np.zeros((left.shape[0], h, w), bool)
    dh, dw = raw["disparity"].shape[1:3]
    gt[:, t:t + dh, l:l + dw] = raw["disparity"]
    m[:, t:t + dh, l:l + dw] = raw["disparity_mask"]
    return {"left": left, "right": right, "disparity": gt, "mask": m,
            "label_idx": make_label_index(raw["label_type"], loss_cfg)}


def step_rng(seed: int, step: int, micro: int = 0) -> np.ndarray:
    """The dropout key of a (micro-)batch: (2,) uint32 from (seed, step,
    micro), the same on every rank."""
    return np.random.default_rng([seed, step, micro]).integers(0, 2 ** 31, size=2).astype(np.uint32)


def plan_ranks(args) -> tuple[int, int, str]:
    """(data, spatial, backend) of the run: a launcher's ``WORLD_SIZE`` where
    it set one, else ``--n_devices`` (0: every visible card, 1 on the CPU),
    factored as ``make_mesh`` factors it. Raises where the plan cannot run:
    no card for ``--device cuda``, ``nccl`` on the CPU or with more local
    ranks than cards, a batch that ``data`` does not split."""
    import torch

    from foundationstereo_torch.models.foundation_stereo import resolve_device
    from foundationstereo_torch.parallel.mesh import factor

    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if args.n_devices not in (0, world):
            raise ValueError(f"--n_devices {args.n_devices} but the launcher's WORLD_SIZE is {world}")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        world = args.n_devices or (cards if device.type == "cuda" else 1)
        local = world
    backend = args.dist_backend or ("nccl" if device.type == "cuda" else "gloo")
    if world > 1 and backend == "nccl":
        if device.type != "cuda":
            raise ValueError("--dist_backend nccl needs --device cuda")
        if local > cards:
            raise ValueError(f"{local} ranks on this host but {cards} visible card(s): NCCL refuses "
                             "two ranks on one device; pass --dist_backend gloo to share cards")
    data, spatial = factor(world)
    if args.batch_size % data:
        raise ValueError(f"--batch_size {args.batch_size} does not split over the {data} data "
                         f"ranks of {world} = data {data} x spatial {spatial}: each data index "
                         "takes an equal slice of the global batch")
    return data, spatial, backend


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> dict:
    """Runs the training; returns the last logged metrics line."""
    args = parse_args(argv)
    data, spatial, backend = plan_ranks(args)
    world = data * spatial
    if world > 1 and "RANK" not in os.environ:
        import torch.multiprocessing as mp

        mp.spawn(train, args=(args, world, backend, f"tcp://localhost:{_free_port()}"),
                 nprocs=world, join=True)
        lines = (Path(args.workspace) / "metrics.jsonl").read_text().splitlines()
        return json.loads(lines[-1]) if lines else {}
    rank = int(os.environ["RANK"]) if world > 1 else 0
    return train(rank, args, world, backend, None)


def train(rank: int, args, world: int, backend: str, url: str | None) -> dict:
    """The training loop of one rank (of ``world``; ``url`` None: the
    launcher's environment names the group)."""
    import torch

    from foundationstereo_torch.parallel import distributed, make_mesh, mesh_context
    from foundationstereo_torch.train.checkpoints import CheckpointManager
    from foundationstereo_torch.train.dataloader import StereoTrainDataLoaderPipeline
    from foundationstereo_torch.train.trainer import Trainer
    from foundationstereo_torch.utils.misc import set_seed

    config = apply_overrides(json.loads(Path(args.config).read_text()), args.override)
    workspace = Path(args.workspace)
    lead = rank == 0
    if lead:
        workspace.mkdir(parents=True, exist_ok=True)
        (workspace / "config.json").write_text(json.dumps(config, indent=2))
    device = torch.device(args.device)
    if world > 1:
        if device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(device)
        distributed.initialize(url, world, rank, backend)
    mesh = make_mesh() if world > 1 else None
    data_index = 0 if mesh is None else mesh.data_index
    draws = mesh is None or mesh.spatial_index == 0     # hands its batches to its spatial group
    set_seed(args.seed + data_index)
    print(f"device: {device}" + (f", rank {rank} of {world} ({backend}), {mesh}" if world > 1
                                 else ""), flush=True)

    mlflow = None
    if args.mlflow and lead:
        try:
            import mlflow as _mlflow
            mlflow = _mlflow
            mlflow.start_run()
            mlflow.log_params({f"model.{k}": v for k, v in config["model"].items()})
        except Exception as e:  # noqa: BLE001 -- soft-fail like the reference
            print(f"mlflow disabled: {e}")

    data_pipe = None
    if draws:
        data_pipe = StereoTrainDataLoaderPipeline(
            config["data"], args.batch_size // (1 if mesh is None else mesh.shape["data"]),
            num_load_workers=4)
        data_pipe.start()

    def get():
        return data_pipe.get() if draws else None

    def place(raw):
        host = None if raw is None else host_batch(raw, config["loss"])
        return distributed.host_local_batch_to_global(host, device, mesh)

    try:
        trainer = Trainer(config, seed=args.seed, enable_ema=bool(args.ema), device=device)
        batch = place(get())
        state = trainer.init_state()
        ckpt = CheckpointManager(workspace / "checkpoints", max_to_keep=5)
        initial_step = 0
        if args.checkpoint != "none":
            state, initial_step = ckpt.restore(args.checkpoint, state)
            if initial_step and lead:
                print(f"resumed from step {initial_step}", flush=True)

        def save(step):
            if lead:
                ckpt.save(step, state, config=config)
            distributed.barrier(device)

        metrics_log = open(workspace / "metrics.jsonl", "a") if lead else None
        records, line = [], {}
        t_last = time.time()
        prof_range = [int(x) for x in args.profile_steps.split(",")] if args.profile_steps else None
        prof = None
        for step in range(initial_step, args.num_iterations):
            if lead and prof_range and step == prof_range[0]:
                prof = torch.profiler.profile(record_shapes=False)
                prof.__enter__()
            t0 = time.perf_counter()
            micros = [batch] + [place(get())
                                for _ in range(args.gradient_accumulation_steps - 1)]
            for i, micro in enumerate(micros):
                micro["rng"] = step_rng(args.seed, step, i)
            with mesh_context(mesh):
                if len(micros) > 1:
                    state, metrics = trainer.train_step_accum(state, micros)
                else:
                    state, metrics = trainer.train_step(state, batch)
            t_dispatch = time.perf_counter() - t0
            last_batch = batch
            t0 = time.perf_counter()
            raw = get()
            t_get = time.perf_counter() - t0
            t0 = time.perf_counter()
            batch = place(raw)
            t_data = time.perf_counter() - t0
            # One device-to-host copy of every metric.
            t0 = time.perf_counter()
            keys = list(metrics)
            values = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                                  device=device) for k in keys]).cpu().tolist()
            t_fence = time.perf_counter() - t0
            rec = dict(zip(keys, values), t_dispatch=t_dispatch, t_get=t_get, t_data=t_data,
                       t_fence=t_fence)
            records.append(rec)
            if prof is not None and step == prof_range[1]:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(str(workspace / "profile.json"))
                print(f"profile trace written to {workspace / 'profile.json'}", flush=True)
                prof = None

            if lead and args.vis_every and step % args.vis_every == 0:
                try:
                    from PIL import Image

                    from foundationstereo_torch.utils.vis import vis_disparity
                    disp, _ = trainer.eval_step(state, last_batch)
                    panel = np.concatenate([
                        last_batch["left"][0].cpu().numpy().astype(np.uint8),
                        vis_disparity(last_batch["disparity"][0].cpu().numpy()),
                        vis_disparity(disp[0].float().cpu().numpy())], axis=1)
                    vis_dir = workspace / "vis"
                    vis_dir.mkdir(exist_ok=True)
                    Image.fromarray(panel).save(vis_dir / f"{step:08d}.png")
                except Exception as e:  # noqa: BLE001 -- vis must not kill training
                    print(f"vis failed: {e}", flush=True)

            if step % args.log_every == 0 or step == initial_step:
                if world > 1:
                    distributed.check_replicas(replica_tensors(state))
                avg = {k: float(np.mean([r[k] for r in records if k in r])) for k in records[-1]}
                dt = time.time() - t_last
                line = {"step": step, "it_per_s": round(len(records) / max(dt, 1e-9), 3), **avg}
                if lead:
                    print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                                      for k, v in line.items()}), flush=True)
                    metrics_log.write(json.dumps(line) + "\n")
                    metrics_log.flush()
                if mlflow:
                    try:
                        mlflow.log_metrics(avg, step=step)
                    except Exception as e:  # noqa: BLE001
                        print(f"mlflow error: {e}")
                records, t_last = [], time.time()

            if step % args.save_every == 0 and step > initial_step:
                save(step)

        if lead:
            ckpt.save(args.num_iterations, state, config=config)
            ckpt.wait()
        distributed.barrier(device)
        if metrics_log:
            metrics_log.close()
    finally:
        if data_pipe is not None:
            data_pipe.stop()
        if world > 1:
            torch.distributed.destroy_process_group()
    print("training done", flush=True)
    return line


def replica_tensors(state) -> dict:
    """What every rank must hold bit for bit: the parameters, the batch
    stats and the EMA."""
    named = dict(state.model.named_parameters())
    named.update(state.model.named_buffers())
    if state.ema is not None:
        named.update({f"ema.{k}": v for k, v in state.ema.items()})
    return named


if __name__ == "__main__":
    main()

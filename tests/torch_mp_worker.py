"""One rank of the port's multi-process CPU tests (tests/test_torch_parallel_mp.py).

    python tests/torch_mp_worker.py RANK WORLD DIR   # join a gloo group
    python tests/torch_mp_worker.py spawn DIR        # cli.main's own launch

A rank joins a gloo group of WORLD ranks through a file under DIR (no TCP
port, so several test workers never collide), with a 60 s timeout on every
collective: a rank that waits on one the others never reach fails instead
of hanging. It runs each job of DIR/jobs_{WORLD}.json in order and writes
what the job returns to DIR/out/{job}.rank{RANK}.pt, on the CPU. A job's
"device" (default "cpu") puts its mesh there: the card tests run the
same jobs on one card, two gloo ranks sharing it. Imports no JAX: the
weights and batches come as numpy files the test wrote.

"spawn" runs cli.main with --table_shards 2 on the CPU and no process
group, so main spawns its two ranks itself (torch.multiprocessing).
"""

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from newsrecommendation_tpu_torch import cli  # noqa: E402
from newsrecommendation_tpu_torch.bridge import params_from_jax  # noqa: E402
from newsrecommendation_tpu_torch.ckpt import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)
from newsrecommendation_tpu_torch.config import Config  # noqa: E402
from newsrecommendation_tpu_torch.data.loader import TrainSamples  # noqa: E402
from newsrecommendation_tpu_torch.eval import cross_process_sum  # noqa: E402
from newsrecommendation_tpu_torch.models import get_model  # noqa: E402
from newsrecommendation_tpu_torch.ops import fused_attention as fa  # noqa: E402
from newsrecommendation_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh,
    replicate,
    shard_batch,
)
from newsrecommendation_tpu_torch.parallel.sharded_embedding import (  # noqa: E402
    gather_rows_sharded,
)
from newsrecommendation_tpu_torch.parallel.spmd import (  # noqa: E402
    make_spmd_multi_step,
    make_spmd_news_encoder,
    make_spmd_train_step,
    place_state,
)
from newsrecommendation_tpu_torch.train import (  # noqa: E402
    create_train_state,
    fit,
)


def load_tree(path):
    """A flat npz of "a/b/c" keys -> the nested dict of numpy arrays."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *head, last = key.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = z[key]
    return tree


def flat_leaves(tree, path=()):
    """A nested dict of tensors -> {"a/b/c": tensor}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, path + (k,)))
        return out
    return {"/".join(path): tree}


def flat(tree):
    return {k: v.detach().cpu().clone()
            for k, v in flat_leaves(tree).items()}


def load_batches(path):
    with np.load(path) as z:
        n = len({k.split("/")[0] for k in z.files})
        return [{k.split("/")[1]: z[k] for k in z.files
                 if k.split("/")[0] == str(i)} for i in range(n)]


def setup(job, d):
    cfg = Config(**job["cfg"]).replace(data_parallel=job["dp"],
                                       table_shards=job["ts"])
    mesh = make_mesh(cfg, device=job.get("device", "cpu"))
    params = params_from_jax(load_tree(os.path.join(d, job["params"])),
                             device="cpu")
    state = place_state(create_train_state(cfg, params), cfg, mesh)
    return cfg, mesh, state, get_model(cfg.model)


def job_step(job, d):
    """Steps of the spmd train step over the job's global batches."""
    cfg, mesh, state, model = setup(job, d)
    step = make_spmd_train_step(cfg, model, mesh)
    losses, accs = [], []
    fa.reset_launch_counts()
    for batch in load_batches(os.path.join(d, job["batches"])):
        state, m = step(state, shard_batch(mesh, batch), 0)
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    grads = {k: v.grad.cpu() for k, v in flat_leaves(state.params).items()
             if v.grad is not None}
    return {"loss": losses, "acc": accs, "params": flat(state.params),
            "grads": grads, "step": state.step,
            "launches": {k: fa.launch_counts(k) for k in fa.KERNELS}}


def job_multi(job, d):
    """k steps in one multi-step call and k single steps, from one start."""
    batches = load_batches(os.path.join(d, job["batches"]))
    cfg, mesh, state, model = setup(job, d)
    local = [shard_batch(mesh, b) for b in batches]
    stacked = {k: torch.stack([b[k] for b in local]) for k in local[0]}
    multi = make_spmd_multi_step(cfg, model, mesh, len(local))
    st_multi, ms = multi(state, stacked, 0)
    cfg, mesh, state, model = setup(job, d)
    step = make_spmd_train_step(cfg, model, mesh)
    for b in local:
        state, m = step(state, b, 0)
    return {"multi": flat(st_multi.params), "multi_loss": ms["loss"].tolist(),
            "single": flat(state.params), "single_loss": float(m["loss"]),
            "multi_step": st_multi.step}


def job_gather(job, d):
    """gather_rows_sharded's rows and the local shard's gradient."""
    cfg = Config(**job["cfg"]).replace(data_parallel=1,
                                       table_shards=job["ts"])
    mesh = make_mesh(cfg, device=job.get("device", "cpu"))
    with np.load(os.path.join(d, job["inputs"])) as z:
        table, ids, g = z["table"], z["ids"], z["g"]
    r = table.shape[0] // mesh.ts
    local = torch.from_numpy(
        table[mesh.table_index * r:(mesh.table_index + 1) * r].copy()).to(
            mesh.device)
    local.requires_grad_(True)
    rows = gather_rows_sharded(local, torch.from_numpy(ids).to(mesh.device),
                               mesh)
    rows.backward(torch.from_numpy(g).to(mesh.device))
    return {"rows": rows.detach().cpu(), "grad": local.grad.cpu()}


def job_encoder(job, d):
    cfg, mesh, state, model = setup(job, d)
    with np.load(os.path.join(d, job["inputs"])) as z:
        feats = torch.from_numpy(z["features"])
    with torch.inference_mode():
        out = make_spmd_news_encoder(cfg, model, mesh)(state.params, feats)
    return {"vecs": out.clone()}


def job_xsum(job, d):
    rank = dist.get_rank()
    sums = {"auc": 0.25 + rank, "mrr": 1.5 * rank, "ndcg5": 2.0 + rank,
            "ndcg10": 1e-9 * (rank + 1), "count": 3.0 + rank,
            "samples_seen": 7.0 + rank}
    return {"local": sums, "total": cross_process_sum(sums)}


def job_fit(job, d):
    """fit over this data index's own samples (shards of unequal length)."""
    cfg, mesh, state, model = setup(job, d)
    with np.load(os.path.join(d, job["inputs"])) as z:
        arrays = {k: z[f"{k}_{mesh.data_index}"]
                  for k in ("history", "history_mask", "pos", "neg")}
        feats = z["features"]
    samples = TrainSamples(**arrays)
    state, stats = fit(cfg, model, state, samples, feats, mesh=mesh)
    return {"stats": stats, "params": flat(state.params),
            "step": state.step}


def job_ckpt(job, d):
    """Two steps, a sharded save, a third step; then the save loaded into
    a fresh state at the same mesh, and its third step."""
    batches = load_batches(os.path.join(d, job["batches"]))
    cfg, mesh, state, model = setup(job, d)
    step = make_spmd_train_step(cfg, model, mesh)
    for b in batches[:2]:
        state, _ = step(state, shard_batch(mesh, b), 0)
    ckpt_dir = os.path.join(d, "ckpt")
    path = save_checkpoint(ckpt_dir, "epoch-1-2.ckpt", state, cfg,
                           mesh=mesh, word_dict={"w": 1})
    dist.barrier()
    state, _ = step(state, shard_batch(mesh, batches[2]), 0)
    cfg2, mesh2, fresh, _ = setup(job, d)
    fresh, sidecar = load_checkpoint(path, fresh, cfg2, mesh=mesh2)
    resumed_step = fresh.step
    fresh, _ = make_spmd_train_step(cfg2, model, mesh2)(
        fresh, shard_batch(mesh2, batches[2]), 0)
    return {"through": flat(state.params), "resumed": flat(fresh.params),
            "resumed_step": resumed_step, "sidecar": sidecar}


def job_replicate(job, d):
    """replicate: a broadcast from rank 0, then a check that passes on the
    broadcast tree and raises on a tree the ranks hold apart."""
    rank = dist.get_rank()
    mesh = make_mesh(Config(), data_parallel=dist.get_world_size(),
                     device="cpu")
    tree = {"a": torch.full((3,), float(rank)), "b": {"c": torch.arange(
        4.0) * (rank + 1)}}
    replicate(mesh, tree)
    replicate(mesh, tree, check=True)
    apart = {"x": torch.full((2,), float(rank))}
    try:
        replicate(mesh, apart, check=True)
        raised = False
    except ValueError:
        raised = True
    return {"tree": flat(tree), "raised": raised}


def job_bridge(job, d):
    """state_from_jax onto the mesh, then state_to_jax back from it."""
    from newsrecommendation_tpu_torch.bridge import (
        state_from_jax,
        state_to_jax,
    )

    cfg = Config(**job["cfg"]).replace(table_shards=job["ts"])
    mesh = make_mesh(cfg, device="cpu")
    params = load_tree(os.path.join(d, job["params"]))
    adam = load_tree(os.path.join(d, job["adam"]))
    state = state_from_jax(params, adam, cfg, step=3, device="cpu",
                           mesh=mesh)
    step, back, opt = state_to_jax(state, cfg, mesh)
    return {"step": step, "local_rows": int(
        state.params["embedding_table"].shape[0]),
            "params": back, "adam": opt["inner_states"]["train"][
                "inner_state"]["0"]}


def job_cli(job, d):
    """cli.main on the joined group: train_test, then test."""
    for argv in job["argvs"]:
        cli.main(argv, device="cpu")
    return {}


JOBS = {"step": job_step, "multi": job_multi, "gather": job_gather,
        "encoder": job_encoder, "xsum": job_xsum, "fit": job_fit,
        "ckpt": job_ckpt, "cli": job_cli, "replicate": job_replicate,
        "bridge": job_bridge}


def main():
    torch.set_num_threads(1)
    if sys.argv[1] == "spawn":
        d = sys.argv[2]
        with open(os.path.join(d, "spawn.json"), encoding="utf-8") as f:
            argv = json.load(f)
        cli.main(argv, device="cpu")
        return
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(d, f'init_{world}')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=60))
    try:
        with open(os.path.join(d, f"jobs_{world}.json"),
                  encoding="utf-8") as f:
            jobs = json.load(f)
        os.makedirs(os.path.join(d, "out"), exist_ok=True)
        for job in jobs:
            out = JOBS[job["kind"]](job, d)
            torch.save(out, os.path.join(
                d, "out", f"{job['name']}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

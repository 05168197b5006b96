"""Command-line driver: train / test / train_test / serve /
create_embeddings / read_embeddings, the JAX package's ``cli.py`` (the
reference main.py dispatcher) on the port.

    python -m newsrecommendation_tpu_torch.cli --mode train_test \
        --train_data_dir data/MINDsmall_train \
        --test_data_dir data/MINDsmall_dev --model_dir model ...

Flags are the JAX package's (config.config_from_args); a setting the port
does not run raises (config.check_supported). Every mode runs on the
CUDA cards; ``main(argv, device="cpu")`` runs it on the CPU, where each
kernel takes its plain PyTorch version.

Train and test run on a (data, table) mesh of dp x ts ranks, one process
each (parallel/mesh.py; ``--data_parallel``, ``--nGPU``,
``--table_shards``), launched in one of three ways:
  - the caller has initialised a process group: main joins it;
  - RANK / WORLD_SIZE / LOCAL_RANK are set (torchrun): main initialises
    the group from them;
  - otherwise, when the mesh has more than one rank, main spawns them
    itself (torch.multiprocessing, as the reference's mp.spawn), one card
    a rank, meeting through a file store in a temporary directory (a
    free port picked ahead can be taken before the store binds it).
The backend is NCCL on CUDA and gloo on the CPU. One rank and one table
shard run the plain single-device step.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from newsrecommendation_tpu_torch.ckpt import (
    latest_checkpoint,
    load_checkpoint,
)
from newsrecommendation_tpu_torch.config import (
    Config,
    check_supported,
    config_from_args,
)
from newsrecommendation_tpu_torch.data import (
    build_news_features,
    random_word_embeddings,
    read_news,
)
from newsrecommendation_tpu_torch.data.embeddings import (
    create_news_embeddings,
    read_news_embeddings,
)
from newsrecommendation_tpu_torch.data.loader import (
    EvalSamples,
    TrainSamples,
)
from newsrecommendation_tpu_torch.data.mind import load_glove_matrix
from newsrecommendation_tpu_torch.data.prepare import (
    prepare_testing_data,
    prepare_training_data,
)
from newsrecommendation_tpu_torch.eval import (
    compute_news_scoring,
    doc_sim_probe,
    evaluate_impressions,
)
from newsrecommendation_tpu_torch.models import get_model
from newsrecommendation_tpu_torch.ops import kernel_config
from newsrecommendation_tpu_torch.parallel.mesh import (
    device_slots,
    make_mesh,
    mesh_shape,
    rank0_first,
)
from newsrecommendation_tpu_torch.parallel.sharded_embedding import (
    local_rows,
)
from newsrecommendation_tpu_torch.parallel.spmd import (
    make_spmd_news_encoder,
)
from newsrecommendation_tpu_torch.train import create_train_state, fit
from newsrecommendation_tpu_torch.utils import resolve_device
from newsrecommendation_tpu_torch.utils.logging import (
    MetricsLog,
    dump_config,
    setup_logger,
)


def build_embedding_table(cfg, data_dir: str, corpus) -> np.ndarray:
    """The title-embedding input of model init, per title_source: the
    stored per-title table of data_dir, GloVe vectors, or random ones."""
    if cfg.title_source == "doc_table":
        return read_news_embeddings(data_dir, backend=cfg.embedding_backend)
    if cfg.glove_embedding_path:
        matrix, have = load_glove_matrix(
            cfg.glove_embedding_path, corpus.word_dict, cfg.word_embedding_dim)
        logging.info("GloVe: %d/%d words found", len(have),
                     len(corpus.word_dict))
        return matrix
    logging.info("no GloVe path; random-initialized trainable word embeddings")
    return random_word_embeddings(corpus.word_dict, cfg.word_embedding_dim,
                                  cfg.seed)


def init_state(cfg, model, table, device, num_category=0,
               num_subcategory=0):
    """A train state at step 0: the model's params drawn from cfg.seed
    around ``table``, on ``device``; NAML's category tables sized by the
    vocabularies (num_category, num_subcategory entries besides row 0)."""
    return create_train_state(
        cfg, model.init(cfg, table, num_category=num_category,
                        num_subcategory=num_subcategory, seed=cfg.seed,
                        device=device))


def rank_table(table, mesh):
    """The title table this rank holds: the whole table, or on a mesh
    with table shards its rows of the zero-padded table (padded before
    init, as the JAX CLI pads, so the Adam moments have its shape)."""
    if mesh is None or mesh.ts == 1:
        return table
    return local_rows(np.asarray(table, np.float32), mesh.ts,
                      mesh.table_index)


def checkpoint_path(cfg) -> str:
    """cfg.load_ckpt_name in cfg.model_dir (or an absolute path); "latest"
    or none: the newest, resolved now."""
    name = cfg.load_ckpt_name
    path = (latest_checkpoint(cfg.model_dir) if not name or name == "latest"
            else os.path.join(cfg.model_dir, name))
    if path is None:
        raise FileNotFoundError(f"no checkpoint found in {cfg.model_dir}")
    return path


def _param_shapes(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _param_shapes(v, path + (k,))
    else:
        yield "/".join(path), tuple(tree.shape)


def _prepare_shards(mesh, paths, prepare, cfg) -> None:
    """Rank 0 writes the behaviors shards (when cfg.prepare or one is
    missing), the others wait: every rank takes the same branch."""
    def run():
        if cfg.prepare or not all(os.path.exists(p) for p in paths):
            prepare()

    rank0_first(mesh, run)


def run_train(cfg: Config, *, device="cuda", mesh=None):
    """Train on cfg.train_data_dir (resuming from cfg.load_ckpt_name when
    set), saving checkpoints and metrics.jsonl into cfg.model_dir.
    ``mesh``: this rank's place (parallel/mesh.py): it trains on
    behaviors_np{K}_{data_index}.tsv with the rank's table rows,
    cfg.batch_size rows a step. Returns (state, vocabs, stats)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    check_supported(cfg, dev)
    corpus = read_news(os.path.join(cfg.train_data_dir, "news.tsv"), cfg,
                       "train")
    news_features = build_news_features(corpus, cfg)
    table = build_embedding_table(cfg, cfg.train_data_dir, corpus)
    model = get_model(cfg.model)
    state = init_state(cfg, model, rank_table(table, mesh), dev,
                       num_category=len(corpus.category_dict),
                       num_subcategory=len(corpus.subcategory_dict))
    logging.info("Model parameters:")
    for name, shape in _param_shapes(state.params):
        logging.info("  %s \t %s", name, shape)
    if cfg.load_ckpt_name:
        state, _ = load_checkpoint(checkpoint_path(cfg), state, cfg,
                                   mesh=mesh)

    dp = mesh.dp if mesh is not None else 1
    paths = [os.path.join(cfg.train_data_dir,
                          f"behaviors_np{cfg.npratio}_{i}.tsv")
             for i in range(dp)]

    def prepare():
        total = prepare_training_data(cfg.train_data_dir, dp, cfg.npratio,
                                      cfg.seed)
        logging.info("%d training samples, %d batches", total,
                     total // (cfg.batch_size * dp))

    _prepare_shards(mesh, paths, prepare, cfg)
    samples = TrainSamples.from_file(
        paths[mesh.data_index if mesh is not None else 0],
        corpus.news_index, cfg)
    vocabs = {"category_dict": corpus.category_dict,
              "subcategory_dict": corpus.subcategory_dict,
              "word_dict": corpus.word_dict}
    state, stats = fit(cfg, model, state, samples, news_features, mesh=mesh,
                       vocabs=vocabs, save_dir=cfg.model_dir)
    logging.info("training done: %s", stats)
    return state, vocabs, stats


def run_test(cfg: Config, state=None, vocabs: Optional[dict] = None, *,
             device="cuda", mesh=None):
    """Evaluate on cfg.test_data_dir: the given state (fresh from
    run_train, with its vocabs) or the checkpoint cfg.load_ckpt_name
    ("latest" or none: the newest) with its sidecar's vocabs. Phase 1
    encodes the test corpus, the doc-sim probe checks it, phase 2 scores
    every impression; the result goes to the log and to metrics.jsonl.
    ``mesh``: every rank encodes the whole corpus (the sharded encoder
    over a sharded table) and scores its own behaviors_{rank}.tsv; the
    metric sums are added over the ranks, and rank 0 writes the line.
    Returns the mean metrics."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    check_supported(cfg, dev)
    model = get_model(cfg.model)
    if state is None:
        ckpt_path = checkpoint_path(cfg)
        with open(ckpt_path + ".json", "r", encoding="utf-8") as f:
            vocabs = json.load(f)
    corpus = read_news(os.path.join(cfg.test_data_dir, "news.tsv"), cfg,
                       "test",
                       category_dict=vocabs.get("category_dict", {}),
                       subcategory_dict=vocabs.get("subcategory_dict", {}),
                       word_dict=vocabs.get("word_dict", {}))
    news_features = build_news_features(corpus, cfg)
    table = build_embedding_table(cfg, cfg.test_data_dir, corpus)
    if state is None:
        state, _ = load_checkpoint(
            ckpt_path, init_state(
                cfg, model, rank_table(table, mesh), dev,
                num_category=len(corpus.category_dict),
                num_subcategory=len(corpus.subcategory_dict)), cfg,
            mesh=mesh)
    params = state.params
    if cfg.title_source == "doc_table":
        # the per-title table has the test corpus's rows; the weights are
        # the trained ones
        params = dict(params)
        params["embedding_table"] = torch.as_tensor(
            rank_table(table, mesh), dtype=torch.float32).to(
                params["embedding_table"].device)

    encode_fn = (make_spmd_news_encoder(cfg, model, mesh)
                 if mesh is not None and mesh.ts > 1 else None)
    news_scoring = compute_news_scoring(model, params, cfg, news_features,
                                        encode_fn=encode_fn)
    logging.info("news scoring num: %d", news_scoring.shape[0])
    sim = doc_sim_probe(news_scoring, num_pairs=1_000_000, seed=cfg.seed)
    logging.info("News doc-sim: %.4f", sim)

    world = mesh.world if mesh is not None else 1
    paths = [os.path.join(cfg.test_data_dir, f"behaviors_{i}.tsv")
             for i in range(world)]
    _prepare_shards(mesh, paths,
                    lambda: prepare_testing_data(cfg.test_data_dir, world),
                    cfg)
    eval_samples = EvalSamples.from_file(
        paths[mesh.rank if mesh is not None else 0], corpus.news_index, cfg,
        max_candidates=cfg.max_candidates)
    results = evaluate_impressions(model, params, cfg, eval_samples,
                                   news_scoring, log_every=cfg.log_steps)
    logging.info(
        "[*] %d samples: AUC %.2f MRR %.2f nDCG5 %.2f nDCG10 %.2f",
        int(results["samples_seen"]), 100 * results["auc"],
        100 * results["mrr"], 100 * results["ndcg5"], 100 * results["ndcg10"])
    if mesh is None or mesh.rank == 0:
        mlog = MetricsLog(os.path.join(cfg.model_dir, "metrics.jsonl"))
        mlog.write("eval", samples=int(results["samples_seen"]),
                   auc=round(100 * results["auc"], 4),
                   mrr=round(100 * results["mrr"], 4),
                   ndcg5=round(100 * results["ndcg5"], 4),
                   ndcg10=round(100 * results["ndcg10"], 4),
                   doc_sim=round(float(sim), 4), ckpt=cfg.load_ckpt_name)
        mlog.close()
    return results


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _spawned_rank(rank, argv, device, world, init_method):
    """One rank of main's own launch: join the group, run, leave it."""
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(_backend(device), init_method=init_method,
                            rank=rank, world_size=world)
    try:
        main(argv, device=device)
    finally:
        dist.destroy_process_group()


def main(argv=None, *, device="cuda"):
    """Parse ``argv`` and run its mode on ``device`` (raises if it is
    "cuda" and CUDA is missing, or for a setting the port does not run
    yet). The kernel switches are set from the flags first, before any
    model code runs; they are process-wide and stay set. Train and test
    run on the mesh of the flags, launched as the module says."""
    setup_logger()
    cfg = config_from_args(argv)
    dev = resolve_device(device)
    if cfg.nGPU > 1 and cfg.data_parallel == 0:
        # the reference's --nGPU N maps onto the data axis (JAX cli.py)
        cards = (torch.cuda.device_count() if dev.type == "cuda"
                 else cfg.nGPU)
        cfg = cfg.replace(data_parallel=min(cfg.nGPU, cards))
    on_mesh = "train" in cfg.mode or "test" in cfg.mode
    if on_mesh and not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(_backend(dev), init_method="env://")
            try:
                return main(argv, device=device)
            finally:
                dist.destroy_process_group()
        dp, ts = mesh_shape(cfg.data_parallel, cfg.table_shards,
                            device_slots(dev, cfg.data_parallel,
                                         cfg.table_shards))
        if dp * ts > 1:
            if dev.type == "cuda" and dev.index is not None:
                raise ValueError(
                    f"device {device!r}: main's own launch puts one rank "
                    "on each card; pass device='cuda'")
            import torch.multiprocessing as mp

            rendezvous = tempfile.mkdtemp(prefix="newsrec-dist-")
            try:
                mp.spawn(_spawned_rank, nprocs=dp * ts, args=(
                    argv, device, dp * ts,
                    f"file://{os.path.join(rendezvous, 'store')}"))
            finally:
                shutil.rmtree(rendezvous, ignore_errors=True)
            return None
    check_supported(cfg, dev)
    kernel_config.apply(cfg)
    if cfg.debug_nans:
        # fail with a traceback at the first NaN a backward produces
        torch.autograd.set_detect_anomaly(True)
    dump_config(cfg)
    Path(cfg.model_dir).mkdir(parents=True, exist_ok=True)
    mesh = make_mesh(cfg, device=device) if on_mesh else None
    if mesh is not None and mesh.trivial:
        mesh = None  # one rank, no group: the plain step

    state, vocabs = None, None
    if "train" in cfg.mode:
        state, vocabs, _ = run_train(cfg, device=dev, mesh=mesh)
    if "test" in cfg.mode:
        run_test(cfg, state=state, vocabs=vocabs, device=dev, mesh=mesh)
    if cfg.mode == "create_embeddings":
        for data_dir in (cfg.train_data_dir, cfg.test_data_dir):
            create_news_embeddings(data_dir, cfg.num_words_title,
                                   cfg.word_embedding_dim,
                                   backend=cfg.embedding_backend)
    if cfg.mode == "serve":
        from newsrecommendation_tpu_torch.server import run_server

        run_server(cfg, device=dev)
    if cfg.mode == "read_embeddings":
        table = read_news_embeddings(cfg.train_data_dir,
                                     backend=cfg.embedding_backend)
        logging.info("embedding table: %s %s", table.shape, table.dtype)


if __name__ == "__main__":
    main()

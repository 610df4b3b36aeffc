"""Starting the ranks of a multi-device run, and the programs they run.

One process per device (``distributed.py``). ``run_command`` is what the
CLI calls for a sharded ``supervised``, ``predict``, ``unsupervised`` or
``embed``:

- under ``torchrun`` (``WORLD_SIZE`` set) this process is one rank and
  joins the group from the environment (``env://``);
- with ``--coordinator_address host:port --num_processes P
  --process_id i`` it starts this host's ``graph_shards x data_shards /
  P`` ranks, global rank ``i * local + local_rank``, around a TCP store
  at the coordinator (rank 0's host);
- otherwise it starts every rank on this host, around a ``file://``
  store in a temporary directory: one command for N devices, as the JAX
  package's.

A CUDA run puts local rank r on ``cuda:r`` (NCCL) and refuses a host
with fewer cards than ranks; ``--device cpu`` runs gloo ranks.

``check_rank`` runs the sharded functions on inputs from a file and
writes each rank's outputs beside it: the tests hold them to the JAX
package, and ``chip_smoke.py`` to the single-device runner on the card.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from graphsage_tpu_torch.device import resolve_device
from graphsage_tpu_torch.parallel.distributed import (
    fold_seed,
    host_array,
    init_distributed,
    make_grid,
)


def local_devices(device, n: int, what: str) -> list:
    """The device of each of this host's ``n`` ranks: ``cuda:r`` for local
    rank r, or the CPU. Raises, naming the count, when the host has fewer
    cards; never falls back to the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    if count < n:
        raise RuntimeError(
            f"{what} needs {n} CUDA devices on this host (one per rank); "
            f"it has {count}. Pass --device cpu to run the ranks on the CPU")
    return [torch.device("cuda", r) for r in range(n)]


def _rank_main(local_rank: int, fn, args: tuple, devices: list,
               init_method: str, world_size: int, rank_offset: int,
               backend: str | None) -> None:
    device = devices[local_rank]
    if device.type == "cpu":
        # the host's cores are split between its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    init_distributed(init_method, world_size, rank_offset + local_rank,
                     device, backend)
    try:
        fn(device, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, args: tuple, devices: list, init_method: str,
          world_size: int | None = None, rank_offset: int = 0,
          backend: str | None = None,
          timeout_s: float | None = None) -> None:
    """Run ``fn(device, *args)`` in one new process per entry of
    ``devices`` (ranks ``rank_offset ..``), each joined to the group at
    ``init_method``, and wait for all of them. A rank that raises fails
    the call with its traceback (the others are ended); past
    ``timeout_s`` seconds every rank is killed and TimeoutError raised.
    ``fn`` is pickled by reference: it lives in a module that the
    children import."""
    ctx = mp.start_processes(
        _rank_main, args=(fn, args, devices, init_method,
                          world_size or len(devices), rank_offset, backend),
        nprocs=len(devices), join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(devices)} ranks did not finish within "
                    f"{timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()


def run_command(fn, args: tuple, graph_shards: int, data_shards: int,
                device="cuda", coordinator_address: str | None = None,
                num_processes: int | None = None,
                process_id: int | None = None) -> None:
    """Run ``fn(device, *args)`` on every rank of a ``graph_shards x
    data_shards`` run, started as the module docstring says."""
    total = graph_shards * data_shards
    what = f"--graph_shards {graph_shards} x --data_shards {data_shards}"
    if "WORLD_SIZE" in os.environ:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", local_rank + 1))
        dev = local_devices(device, n_local, what)[local_rank]
        init_distributed("env://", int(os.environ["WORLD_SIZE"]),
                         int(os.environ["RANK"]), dev)
        try:
            fn(dev, *args)
        finally:
            dist.destroy_process_group()
        return
    n_proc = num_processes or 1
    if coordinator_address is not None or n_proc > 1:
        if not coordinator_address:
            raise ValueError("--num_processes above 1 needs "
                             "--coordinator_address host:port")
        if total % n_proc:
            raise ValueError(
                f"{what} = {total} ranks do not split evenly over "
                f"--num_processes {n_proc}")
        if process_id is None or not 0 <= process_id < n_proc:
            raise ValueError(f"--process_id must be in [0, {n_proc}), got "
                             f"{process_id}")
        n_local = total // n_proc
        spawn(fn, args, local_devices(device, n_local, what),
              f"tcp://{coordinator_address}", world_size=total,
              rank_offset=process_id * n_local)
        return
    devices = local_devices(device, total, what)
    store = tempfile.mkdtemp(prefix="graphsage_store_")
    try:
        spawn(fn, args, devices, f"file://{store}/store")
    finally:
        shutil.rmtree(store, ignore_errors=True)


# -------------------------------------------------------- the programs

def supervised_rank(device, flags) -> None:
    from graphsage_tpu_torch.train.supervised import train

    train(flags, device=device)


def predict_rank(device, flags, out_dir, nodes, num_classes) -> None:
    from graphsage_tpu_torch.infer import predict

    predict(flags, out_dir=out_dir, nodes=nodes, num_classes=num_classes,
            device=device)


def unsupervised_rank(device, flags) -> None:
    from graphsage_tpu_torch.train.unsupervised import train

    train(flags, device=device)


def embed_rank(device, flags, out_dir) -> None:
    from graphsage_tpu_torch.infer import export_embeddings

    export_embeddings(flags, out_dir=out_dir, device=device)


def _local_params(flat: dict, grid, layout: str, device, sharded: bool):
    """NumPy params (``embeds`` in canonical order) -> this rank's
    tensors: its shard of ``embeds`` when ``sharded``."""
    from graphsage_tpu_torch.parallel.graph_sharded import local_shard

    out = {}
    for k, v in flat.items():
        if k == "embeds" and sharded:
            v = local_shard(v, grid.graph_size, grid.graph_rank, layout)
        out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return out


def _sage(job):
    """The job's SAGEConfig, of its supervised or unsupervised config."""
    return (job["sup_config"] if "sup_config" in job
            else job["unsup_config"]).sage


def _tables(job, grid, device, sharded: bool):
    from graphsage_tpu_torch.parallel.graph_sharded import local_shard

    layout = _sage(job).shard_layout
    out = []
    for name in ("features", "adj"):
        t = job[name]
        if sharded:
            t = local_shard(t, grid.graph_size, grid.graph_rank, layout)
        out.append(torch.from_numpy(np.array(t, copy=True)).to(device))
    return out


def _check_exchange(job, grid, device) -> dict:
    from graphsage_tpu_torch.parallel.graph_sharded import (
        exchange_gather,
        local_shard,
    )

    local = torch.from_numpy(local_shard(
        job["table"], grid.graph_size, grid.graph_rank, job["layout"])
    ).to(device)
    weights = job.get("weights")
    if weights is not None:
        local.requires_grad_(True)
    idx = torch.from_numpy(job["idx"][grid.me]).to(device)
    rows, dropped = exchange_gather(
        local, idx, grid.graph_group, job["capacity"], return_dropped=True,
        split_local=job["split_local"], layout=job["layout"],
        remote_only=job["remote_only"])
    out = {"rows": rows.detach().cpu().numpy(), "dropped": int(dropped)}
    if weights is not None:
        (rows * torch.from_numpy(weights[grid.me]).to(device)).sum(
        ).backward()
        out["grad"] = local.grad.cpu().numpy()
    return out


def _check_embed(job, grid, device) -> dict:
    from graphsage_tpu_torch.parallel.graph_sharded import (
        sharded_sage_embed,
    )

    config = job["sup_config"].sage
    params = _local_params(job["params"], grid, config.shard_layout, device,
                           True)
    feat, adj = _tables(job, grid, device, True)
    lb = len(job["ids"]) // grid.total
    ids = torch.from_numpy(job["ids"][grid.me * lb:(grid.me + 1) * lb]).to(
        device)
    out = {}
    for halo in ("overlap", "blocking"):
        with torch.no_grad():
            emb, dropped = sharded_sage_embed(
                params, feat, adj, ids, config, grid.graph_group,
                job["capacity_factor"], deterministic=True,
                return_stats=True, halo=halo)
        out[halo] = emb.cpu().numpy()
        out[f"{halo}_dropped"] = int(dropped)
    return out


def _check_split_mean(job, grid, device) -> dict:
    """The D > 1 inner hop's mean with dropout (``_split_mean``) beside
    the same mean built by hand: every row through the exchange, each
    element masked by its share's Philox stream (the local rows'
    ``LOCAL_DROP_TAG``, the remote rows' ``REMOTE_DROP_TAG``), keyed as
    the runner keys it (the seed folded with ``grid.me``)."""
    from graphsage_tpu_torch.ops.philox import philox_dropout
    from graphsage_tpu_torch.parallel.graph_sharded import (
        LOCAL_DROP_TAG,
        REMOTE_DROP_TAG,
        _owner_of,
        _split_mean,
        exchange_gather,
        local_shard,
    )

    D, layout, S0, p = (grid.graph_size, job["layout"], job["S0"],
                        job["rate"])
    local = torch.from_numpy(local_shard(job["table"], D, grid.graph_rank,
                                         layout)).to(device)
    flat = torch.from_numpy(job["idx"][grid.me]).to(device)
    seed, step = fold_seed(job["seed"], grid.me), job["step"]
    mean, dropped = _split_mean(local, flat, S0, grid.graph_group,
                                grid.graph_rank, D, layout, float(D), p,
                                seed, step)
    rows = exchange_gather(local, flat, grid.graph_group, flat.shape[0],
                           layout=layout)
    ones = torch.ones_like(rows)
    masks = [philox_dropout(ones, p, seed, step, tag)
             for tag in (LOCAL_DROP_TAG, REMOTE_DROP_TAG)]
    owner, _ = _owner_of(flat.long(), D, local.shape[0], layout)
    is_local = (owner == grid.graph_rank).view(-1, 1)
    by_hand = (rows * torch.where(is_local, *masks)).view(
        -1, S0, rows.shape[1]).sum(dim=1) / S0
    return {"mean": mean.cpu().numpy(), "by_hand": by_hand.cpu().numpy(),
            "local_mask": masks[0].cpu().numpy(),
            "remote_mask": masks[1].cpu().numpy(),
            "is_local": is_local.view(-1).cpu().numpy(),
            "dropped": int(dropped)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_train(job, grid, device) -> dict:
    from graphsage_tpu_torch.models.supervised import (
        make_optimizer,
        supervised_predict,
    )
    from graphsage_tpu_torch.parallel.dp import (
        make_dp_supervised_chunk_runner,
    )
    from graphsage_tpu_torch.parallel.graph_sharded import (
        gather_canonical,
        make_sharded_supervised_chunk_runner,
    )

    sup = job["sup_config"]
    layout = sup.sage.shard_layout
    sharded = job["runner"] == "sharded"
    params = _local_params(job["params"], grid, layout, device, sharded)
    feat, adj = _tables(job, grid, device, sharded)
    optimizer = make_optimizer(job["lr"])
    opt_state = optimizer.init(params)
    B = job["batch_size"]
    if sharded:
        run = make_sharded_supervised_chunk_runner(
            sup, optimizer, grid, B, capacity_factor=job["capacity_factor"])
    else:
        run = make_dp_supervised_chunk_runner(sup, optimizer, grid, B)
    ids_perm = torch.from_numpy(job["ids_perm"]).to(device)
    labels_table = torch.from_numpy(job["labels_table"]).to(device)
    gen = torch.Generator(device=device).manual_seed(
        fold_seed(job.get("seed", 0), grid.me))
    chunks = []
    for start, n in job["chunks"]:
        _sync(device)
        t0 = time.perf_counter()
        out = run(params, opt_state, gen, feat, adj, ids_perm, labels_table,
                  start, n, drop_seed=job.get("drop_seed", 0))
        loss = float(out[2])
        _sync(device)
        seconds = time.perf_counter() - t0
        params, opt_state = out[0], out[1]
        preds = supervised_predict(out[3], sup)
        chunks.append({"loss": loss, "preds": preds.cpu().numpy(),
                       "ids": out[4].cpu().numpy(), "seconds": seconds,
                       "dropped": int(out[5]) if sharded else 0})
    final = {k: v.detach().cpu().numpy() for k, v in params.items()
             if k != "embeds" or not sharded}
    if sharded and "embeds" in params:
        final["embeds"] = gather_canonical(
            params["embeds"].detach(), grid, sup.sage.num_nodes + 1,
            layout).numpy()
    return {"chunks": chunks, "params": final}


def _check_sweep(job, grid, device) -> dict:
    from graphsage_tpu_torch.parallel.graph_sharded import (
        make_sharded_supervised_eval_sweep,
        reassemble_sharded_rows,
    )
    from graphsage_tpu_torch.train.supervised import labels_table_of

    sup = job["sup_config"]
    params = _local_params(job["params"], grid, sup.sage.shard_layout, device,
                           True)
    feat, adj = _tables(job, grid, device, True)
    B, N = job["batch_size"], sup.sage.num_nodes
    nodes = job["nodes"]
    n_b = max(1, -(-len(nodes) // B))
    ids_all = np.full((n_b * B,), N, dtype=np.int32)
    ids_all[:len(nodes)] = nodes
    sweep = make_sharded_supervised_eval_sweep(
        sup, grid, B, capacity_factor=job["capacity_factor"])
    _sync(device)
    t0 = time.perf_counter()
    losses, preds, dropped = sweep(
        params, feat, adj, torch.from_numpy(ids_all).to(device),
        torch.from_numpy(labels_table_of(job["labels"], N)).to(device),
        torch.Generator(device=device).manual_seed(job.get("seed", 0)))
    rows = reassemble_sharded_rows(host_array(preds), grid.total, n_b)
    _sync(device)
    return {"losses": losses.cpu().numpy(), "preds": rows[:len(nodes)],
            "dropped": int(dropped), "seconds": time.perf_counter() - t0}


def _gathered_params(params: dict, grid, sage, sharded: bool) -> dict:
    """Host copies of this rank's params, the identity table whole and
    canonical (a collective call when ``sharded``)."""
    from graphsage_tpu_torch.parallel.graph_sharded import gather_canonical

    out = {k: v.detach().cpu().numpy() for k, v in params.items()
           if k != "embeds" or not sharded}
    if sharded and "embeds" in params:
        out["embeds"] = gather_canonical(
            params["embeds"].detach(), grid, sage.num_nodes + 1,
            sage.shard_layout).numpy()
    return out


def _check_unsup_train(job, grid, device) -> dict:
    """The sharded (``runner`` "sharded", ``neg_ids`` [steps, total,
    n_neg]) or data-parallel ("dp", [steps, n_neg]) unsupervised runner
    over ``chunks``: each chunk's loss, MRR, EMA, dropped count and
    seconds, and the params at the end (with ``first``, also after the
    first chunk)."""
    from graphsage_tpu_torch.models.supervised import make_optimizer
    from graphsage_tpu_torch.parallel.dp import (
        make_dp_unsupervised_chunk_runner,
    )
    from graphsage_tpu_torch.parallel.graph_sharded import (
        make_sharded_unsupervised_chunk_runner,
    )

    unsup = job["unsup_config"]
    sharded = job["runner"] == "sharded"
    params = _local_params(job["params"], grid, unsup.sage.shard_layout,
                           device, sharded)
    feat, adj = _tables(job, grid, device, sharded)
    optimizer = make_optimizer(job["lr"])
    opt_state = optimizer.init(params)
    B = job["batch_size"]
    if sharded:
        run = make_sharded_unsupervised_chunk_runner(
            unsup, optimizer, grid, B, capacity_factor=job["capacity_factor"])
    else:
        run = make_dp_unsupervised_chunk_runner(unsup, optimizer, grid, B)
    pairs = torch.from_numpy(job["pairs_perm"]).to(device)
    negs = torch.from_numpy(job["neg_ids"]).to(device)
    gen = torch.Generator(device=device).manual_seed(
        fold_seed(job.get("seed", 0), grid.me))
    shadow = torch.full((), -1.0, device=device)
    chunks = []
    for start, n in job["chunks"]:
        _sync(device)
        t0 = time.perf_counter()
        out = run(params, opt_state, shadow, gen, feat, adj, pairs, negs,
                  start, n, drop_seed=job.get("drop_seed", 0))
        loss, mrr, ema = float(out[3]), float(out[4]), float(out[2])
        _sync(device)
        seconds = time.perf_counter() - t0
        params, opt_state, shadow = out[0], out[1], out[2]
        chunks.append({"loss": loss, "mrr": mrr, "ema": ema,
                       "dropped": int(out[5]) if sharded else 0,
                       "seconds": seconds})
        if job.get("first") and len(chunks) == 1:
            first = _gathered_params(params, grid, unsup.sage, sharded)
    result = {"chunks": chunks,
              "params": _gathered_params(params, grid, unsup.sage, sharded)}
    if job.get("first"):
        result["first"] = first
    return result


def _check_unsup_eval(job, grid, device) -> dict:
    """The sharded unsupervised eval of one batch (``batch`` = (b1, b2,
    mask)), the eval sweep over ``pairs`` and the embed sweep over
    ``nodes``, each where the job names its input; the embed rows in
    node order."""
    from graphsage_tpu_torch.parallel.graph_sharded import (
        make_sharded_unsup_eval_sweep,
        make_sharded_unsupervised_eval,
    )
    from graphsage_tpu_torch.train.unsupervised import (
        sharded_embed_all_nodes,
    )

    unsup = job["unsup_config"]
    params = _local_params(job["params"], grid, unsup.sage.shard_layout,
                           device, True)
    feat, adj = _tables(job, grid, device, True)
    B, cap = job["batch_size"], job["capacity_factor"]

    def gen():
        return torch.Generator(device=device).manual_seed(job.get("seed", 0))

    def host(values):
        return tuple(float(v) for v in values[:2]) + (int(values[2]),)

    out = {}
    if "batch" in job:
        batch = [torch.from_numpy(x).to(device) for x in job["batch"]]
        negs = torch.from_numpy(job["val_negs"]).to(device)
        out["eval"] = host(make_sharded_unsupervised_eval(
            unsup, grid, capacity_factor=cap)(params, feat, adj, *batch,
                                              negs, gen()))
    if "pairs" in job:
        negs = torch.from_numpy(job["val_negs"]).to(device)
        _sync(device)
        t0 = time.perf_counter()
        out["sweep"] = host(make_sharded_unsup_eval_sweep(
            unsup, grid, B, capacity_factor=cap)(
                params, feat, adj, torch.from_numpy(job["pairs"]).to(device),
                negs, gen()))
        out["sweep_seconds"] = time.perf_counter() - t0
    if job.get("embed"):
        _sync(device)
        t0 = time.perf_counter()
        rows, dropped = sharded_embed_all_nodes(
            unsup, grid, B, params, feat, adj, job.get("seed", 0), cap)
        out["embed"] = rows
        out["embed_dropped"] = int(dropped)
        out["embed_seconds"] = time.perf_counter() - t0
    return out


def _check_masked_mrr(job, grid, device) -> dict:
    """``_global_masked_mrr`` of this rank's reciprocal ranks ``rr`` and
    ``mask`` (rows ``grid.me`` of the job's) over the graph group."""
    from graphsage_tpu_torch.parallel.graph_sharded import _global_masked_mrr

    rr, mask = (torch.from_numpy(job[k][grid.me]).to(device)
                for k in ("rr", "mask"))
    sums = torch.stack([(rr * mask).sum(), mask.sum()])
    return float(_global_masked_mrr(sums, grid.graph_group))


CHECKS = {"exchange": _check_exchange, "embed": _check_embed,
          "split_mean": _check_split_mean, "train": _check_train,
          "sweep": _check_sweep, "unsup_train": _check_unsup_train,
          "unsup_eval": _check_unsup_eval, "masked_mrr": _check_masked_mrr}


def check_rank(device, job_path: str, out_dir: str) -> None:
    """Run the jobs of ``job_path`` (a ``torch.save``d dict name -> job,
    each with its ``kind`` and ``grid`` = (graph_shards, data_shards),
    written by the caller) and save this rank's outputs to
    ``out_dir/rank<r>.pt``."""
    jobs = torch.load(job_path, weights_only=False)
    grids, results = {}, {}
    for name, job in jobs.items():
        shape = tuple(job["grid"])
        if shape not in grids:
            grids[shape] = make_grid(*shape)
        results[name] = CHECKS[job["kind"]](job, grids[shape], device)
    torch.save(results, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))

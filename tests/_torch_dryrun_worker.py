"""The dry-run traces of ``test_torch_dryrun.py``, run in a process of
their own (the fake process group is process-wide): ``python
_torch_dryrun_worker.py <job> <out.json>``.  Imports no JAX.

Jobs (each writes one JSON object):

* ``data`` — on an (8, 1) ``("data", "model")`` mesh of a fake group, the
  llama3-8b and mamba2-780m smoke configs' train step (remat "dots") and
  prefill at a global batch of 16 and 8, beside the unsharded step's
  count at the local batch (2 and 1); and a DTensor matmul's first call
  on a (2, 4) mesh (its sharding propagation runs it once more on
  global-shape fakes); then, on a one-rank group, the llama3-8b smoke
  train step's count beside ``FlopCounterMode``'s of the same step run
  for real (unsharded) on the CPU.
* ``model`` — on a (1, 8) mesh: the llama3-8b smoke train step at a
  global batch of 8, beside the unsharded step's count at that batch;
  the qwen2-moe-a2.7b smoke train step through the expert-parallel path;
  and ``lower_cell`` of internvl2-1b × decode_32k at full width on the
  production (16, 16) mesh, with its leaves' local bytes.
"""
import json
import sys

import torch

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import RunConfig, build

SMOKE_RUN = RunConfig(remat="dots")


def traced(arch, mesh, shape, global_batch, run=SMOKE_RUN):
    model = build(arch, run, smoke=True, device="cpu")
    return dryrun.trace(model, mesh, shape, global_batch)


def job_data() -> dict:
    dryrun.fake_group(8)
    mesh = make_mesh((8, 1), ("data", "model"), "cpu")
    out = {}
    for arch in ("llama3-8b", "mamba2-780m"):
        for shape, batch in (("train_4k", 16), ("prefill_32k", 8)):
            out[f"{arch}/{shape}"] = {
                "mesh": traced(arch, mesh, shape, batch),
                "one": traced(arch, None, shape, batch // 8)}
    out["matmul"] = matmul_count()
    out["one_rank"] = one_rank_vs_real()
    return out


def one_rank_vs_real() -> dict:
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import make_train_step
    dryrun.fake_group(1)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    model = build("llama3-8b", SMOKE_RUN, smoke=True, device="cpu")
    dry = dryrun.trace(model, mesh, "train_4k", 2)["flops"]
    params = model.init(0)
    batch = batch_at(DataConfig(seq_len=4096, global_batch=2), 0, model.cfg)
    with FlopCounterMode(display=False) as fc:
        make_train_step(model)(params, init_opt_state(params), batch)
    return {"dry": dry, "real": fc.get_total_flops()}


def matmul_count() -> dict:
    """x [64, 256] split over data (2) by rows, w [256, 512] over model
    (4) by columns: the local product is [32, 256] @ [256, 128]."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(32, 256), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(256, 128), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        counts = []
        for _ in range(2):
            count = dryrun.Count(keep=(x, w))
            with count.beneath_dtensor():
                y = x @ w
            counts.append(count.flops)
        return {"flops": counts, "local": 2 * 32 * 256 * 128,
                "out_local": list(y.to_local().shape)}


def job_model() -> dict:
    from repro_torch.models import moe
    dryrun.fake_group(8)
    mesh = make_mesh((1, 8), ("data", "model"), "cpu")
    out = {"llama3-8b/train_4k": {
        "mesh": traced("llama3-8b", mesh, "train_4k", 8),
        "global": traced("llama3-8b", None, "train_4k", 8)}}
    calls = moe.EXPERT_PARALLEL_CALLS
    out["qwen2-moe-a2.7b/train_4k"] = traced("qwen2-moe-a2.7b", mesh,
                                             "train_4k", 8)
    out["expert_parallel_calls"] = moe.EXPERT_PARALLEL_CALLS - calls
    out["internvl2-1b/decode_32k"] = dryrun.lower_cell(
        "internvl2-1b", "decode_32k", False, device="cpu")
    out["leaf_bytes"] = leaf_bytes("internvl2-1b", "decode_32k")
    return out


def leaf_bytes(arch, shape) -> dict:
    """Rank 0's bytes of every argument leaf of the cell, by path."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.mesh import make_production_mesh
    model = build(arch, RunConfig(remat="full"), device="cpu")
    mesh = make_production_mesh(device_type="cpu")
    got = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        else:
            got[path] = dryrun.storage_bytes(t)
    with FakeTensorMode(allow_non_fake_inputs=True):
        _, args = dryrun._lower_model(model, mesh, shape)
        walk({f"arg{i}": a for i, a in enumerate(args)}, "")
    return got


if __name__ == "__main__":
    job, path = sys.argv[1], sys.argv[2]
    result = {"data": job_data, "model": job_model}[job]()
    with open(path, "w") as f:
        json.dump(result, f)

"""One rank of ``tests/test_torch_parallel.py``'s 8-rank gloo group.

Run as ``python tests/_torch_parallel_worker.py RANK PORT DIR`` by the
test module's ``mesh_run`` fixture, once per rank; rank 0 writes every
result to ``DIR/results.pt``.  It imports ``repro_torch`` only (no JAX,
nothing of the reference), so that the eight ranks start quickly; the
test module imports the inputs and helpers below from here.
"""
import sys
from pathlib import Path

import numpy as np
import torch

WORLD = 8
MESH = (2, 4)                       # ("data", "model")
MOE = "qwen2-moe-a2.7b"
DENSE = ("llama3-8b", "zamba2-1.2b")
# The reference mesh test's setup for the expert-parallel step.
MOE_RUN = dict(remat="none", learning_rate=1e-3)
# The same step in fp32 compute with a capacity at which no slot is
# dropped, neither per rank (capacity from the local tokens) nor on one
# device (from all of them): a capacity factor of e_pad / top_k = 8 / 2
# makes each expert's capacity the token count.  The expert-parallel and
# dense paths then compute the same function, and its gradient is held
# tightly.  (The compute dtype is added where each framework's RunConfig
# is built.)
MOE_NO_DROP = dict(MOE_RUN, moe_capacity=4.0)


def fp32_run():
    from repro_torch.models import RunConfig
    return RunConfig(remat="dots", compute_dtype=torch.float32)


def tokens(seed: int, B: int, L: int, vocab: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, L)) \
        .astype(np.int32)


def dense_batch() -> dict:
    t = torch.from_numpy(tokens(1, 4, 32))
    return {"tokens": t, "labels": t}


def attn_inputs(S: int = 32):
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    v = rng.normal(size=(2, S, 4, 16)).astype(np.float32)
    valid = rng.random((2, S)) < 0.8
    return q, k, v, valid


def unflatten(flat) -> dict:
    """``{"a/b": x}`` → ``{"a": {"b": x}}``."""
    out: dict = {}
    for key, v in flat.items():
        d = out
        *head, last = key.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _moe_step(mesh, outdir: Path, run) -> dict:
    """One expert-parallel qwen2-moe-a2.7b smoke step from the
    reference's ``init(PRNGKey(0))`` parameters (``moe.npz``)."""
    from repro_torch.models import build, moe
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import build_train_step
    m = build(MOE, run, smoke=True, device="cpu")
    p = params_from_numpy(unflatten(dict(np.load(outdir / "moe.npz"))),
                          device="cpu")
    t = torch.from_numpy(tokens(0, 4, 32))
    fn, *_ = build_train_step(m, mesh)
    moe.EXPERT_PARALLEL_CALLS = 0
    p, o, met = fn(p, init_opt_state(p), {"tokens": t, "labels": t})
    return {"params": shd.full(p), "mu": shd.full(o["mu"]),
            "loss": met["loss"], "grad_norm": met["grad_norm"],
            "ep_calls": moe.EXPERT_PARALLEL_CALLS}


def worker(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from repro_torch import ckpt
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.ft.faults import FaultPlan, FaultyTrainer
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import RunConfig, build
    from repro_torch.parallel import collectives as tcoll
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.serve_step import build_decode_step, build_prefill
    from repro_torch.train.optim import init_opt_state
    from repro_torch.train.train_step import build_train_step

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    mesh = make_host_mesh(model=MESH[1], device_type="cpu")
    res: dict = {}
    outdir = Path(out)
    fp32 = fp32_run()

    # (i) qwen2-moe-a2.7b: the expert-parallel step, as the reference
    # mesh test runs it and with no slot dropped
    res["moe"] = _moe_step(mesh, outdir, RunConfig(**MOE_RUN))
    res["moe_no_drop"] = _moe_step(mesh, outdir, RunConfig(
        **MOE_NO_DROP, compute_dtype=torch.float32))

    # (ii) + (iii) dense and hybrid: step, prefill, decode
    for arch in DENSE:
        m = build(arch, fp32, smoke=True, device="cpu")
        fn, ppl, opl, bpl = build_train_step(m, mesh)
        p = m.init(0)
        p, o, met = fn(p, init_opt_state(p), dense_batch())
        res[arch] = {"params": shd.full(p), "opt": shd.full(o),
                     "loss": met["loss"], "grad_norm": met["grad_norm"],
                     "placements": shd.placements_of(p) == ppl
                     and shd.placements_of(o) == opl}
        p = m.init(0)
        toks = torch.from_numpy(tokens(2, 4, 16))
        logits, state = build_prefill(m, "prefill_32k", device="cpu",
                                      max_seq=24, mesh=mesh)(
            p, {"tokens": toks})
        want = shd.state_shardings(m, mesh, "prefill_32k")
        res[arch]["prefill"] = {"logits": logits.full_tensor(),
                                "state": shd.full(state),
                                "placed": shd.placements_of(state) == want}
        # decode from the unsharded prefill's state (the parent's), so
        # that the step is held alone
        ref_state = torch.load(outdir / f"{arch}-state.pt")
        logits, state = build_decode_step(m, "decode_32k", device="cpu",
                                          mesh=mesh)(
            p, ref_state, torch.from_numpy(tokens(3, 4, 1)))
        want = shd.state_shardings(m, mesh, "decode_32k")
        res[arch]["decode"] = {"logits": logits.full_tensor(),
                               "state": shd.full(state),
                               "placed": shd.placements_of(state) == want}

    # (iv) collectives over the 'model' group: shard j's inputs
    group = mesh.get_group("model")
    j = mesh.get_local_rank("model")
    x = torch.from_numpy(np.random.default_rng(20 + j).normal(
        size=(257,)).astype(np.float32))
    mean, resid = tcoll.quantized_psum(x, group)
    q, k, v, valid = map(torch.from_numpy, attn_inputs())
    S = k.shape[1] // MESH[1]
    sl = slice(j * S, (j + 1) * S)
    o = tcoll.seq_sharded_decode_attention(q, k[:, sl], v[:, sl],
                                           valid[:, sl], group)
    res["collectives"] = {"mean": mean, "residual": resid, "attn": o}

    # (v) a checkpoint written from 2 x 4, restored onto 4 x 2
    m = build("llama3-8b", fp32, smoke=True, device="cpu")
    _, ppl, _, _ = build_train_step(m, mesh)
    p = shd.distribute(m.init(0), mesh, ppl)
    ckpt.save_sections(str(outdir / "ckpt"), 1, {"params": p})
    mesh42 = make_mesh((4, 2), ("data", "model"), "cpu")
    pl42 = shd.model_param_shardings(m, mesh42)
    got, _ = ckpt.restore_section(str(outdir / "ckpt"), 1, m.init(0),
                                  device="cpu", mesh=mesh42, placements=pl42)
    res["reshard"] = {"params": shd.full(got),
                      "placed": shd.placements_of(got) == pl42}

    # (vi) FaultyTrainer on the mesh, with restarts, and uninterrupted
    dc = DataConfig(seq_len=32, global_batch=4)
    fn, ppl, opl, _ = build_train_step(m, mesh)
    runs = {}
    for name, prob in (("faulty", 0.3), ("clean", 0.0)):
        tr = FaultyTrainer(str(outdir / f"ft-{name}"),
                           FaultPlan(fail_prob=prob, seed=5, ckpt_every=2))
        p = m.init(0)
        p, o, hist = tr.run(params=p, opt=init_opt_state(p), n_steps=4,
                            step_fn=fn,
                            batch_fn=lambda s: batch_at(dc, s, m.cfg),
                            device="cpu", mesh=mesh, shardings=ppl,
                            opt_shardings=opl)
        runs[name] = {"params": shd.full(p), "opt": shd.full(o),
                      "hist": hist, "restarts": tr.restarts}
    res["ft"] = runs

    if rank == 0:
        torch.save(res, outdir / "results.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

"""The rank side of tests/test_torch_parallel.py: data-parallel train and
eval steps of the port over a gloo process group on the CPU.

Each rank loads the same inputs (a model state, a global batch and the
draws of every step, written by the test), runs the steps as rank r of N
and writes what it saw to ``rank{r}.pt``.  Imports no JAX, so that a rank
starts quickly.
"""

from __future__ import annotations

import copy
import os

import torch
import torch.distributed as dist

from diffphore_torch.models.score_model import ScoreModel
from diffphore_torch.parallel.mesh import DataShard
from diffphore_torch.train import ccsampler, state as tstate

LR = 1e-3
STEPS = 3
#: (kind, the step's probability argument): plain, the rejection
#: curriculum at 0.5, the calibrated sampler at 0.6
KINDS = (("plain", 0.0), ("reject", 0.5), ("cc", 0.6))


def make_step(cfg, kind: str, shard):
    if kind == "cc":
        return ccsampler.make_ccsampler_train_step(cfg, shard=shard)
    return tstate.make_train_step(cfg, reject=kind == "reject", shard=shard)


def fresh_state(cfg, model_state):
    model = ScoreModel(cfg)
    model.load_state_dict(model_state)
    return tstate.create_train_state(cfg, lr=LR, device="cpu", model=model)


def snapshot(state, metrics):
    """What a step leaves: metrics, gradients, batch statistics, EMA and
    parameters, as CPU tensors."""
    model = state.model
    return {"metrics": {k: v.clone() for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "stats": {k: b.clone() for k, b in model.named_buffers()},
            "ema": {k: v.clone() for k, v in state.ema_params.items()},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()}}


def run_steps(inputs, kind: str, prob: float, shard, batch=None):
    cfg = inputs["cfg"]
    state = fresh_state(cfg, inputs["model_state"])
    step = make_step(cfg, kind, shard)
    out = []
    for draws in inputs["draws"][kind]:
        state, m = step(state, inputs["batch"] if batch is None else batch, None, prob, draws)
        out.append(snapshot(state, m))
    return out


def rank_main(rank: int, world: int, port: int, in_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        inputs = torch.load(in_path, weights_only=False)
        shard = DataShard(rank, world)
        out = {kind: run_steps(inputs, kind, prob, shard) for kind, prob in KINDS}

        # the validation-loss step: per-graph values of every row
        cfg = inputs["cfg"]
        model = fresh_state(cfg, inputs["model_state"]).model
        out["eval"] = tstate.make_eval_step(cfg, shard=shard)(model, inputs["batch"], None,
                                                             inputs["eval_draws"])

        # a row of the last rank's share is not finite: every rank skips
        out["nan"] = run_steps(inputs, "plain", 0.0, shard, inputs["nan_batch"])[:1]

        # rank 0 alone in a group of one, and without a shard, in this process
        # (another thread count may sum in another order)
        solo = dist.new_group([0])
        if rank == 0:
            out["solo"], out["alone"] = [
                {kind: run_steps(inputs, kind, prob, one) for kind, prob in KINDS}
                for one in (DataShard(0, 1, solo), None)]
            out["solo_eval"], out["alone_eval"] = [
                tstate.make_eval_step(cfg, shard=one)(copy.deepcopy(model), inputs["batch"], None,
                                                      inputs["eval_draws"])
                for one in (DataShard(0, 1, solo), None)]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()

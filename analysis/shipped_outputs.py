"""The shipped model's outputs on the card from one tree of the repository,
to hold two trees bit for bit (a change that must not move the shipped
path), or to say how far a change that does move it moves it.

    python analysis/shipped_outputs.py TREE OUT.pt     # TREE: a checkout's root
    python analysis/shipped_outputs.py --compare A.pt B.pt

Saved: the corpus2 model's forward of 40 posed rows of the first cached
24 x 96 x 8 complex at bf16 and at f32, a bf16 train step's loss and every
parameter gradient on 24 cached training complexes from seeded fresh weights
and draws, and one FitEngine dispatch's poses (40 x 20 steps) of the second
complex.  Each tree builds its own kernels; run the two trees in separate
processes, for example ``git archive <commit> | tar -x -C build/parent``,
then this script on ``build/parent`` and on ``.``, then ``--compare``.
Needs a GPU.
"""

import os
import sys


def save(root: str, out_path: str) -> None:
    root, out_path = os.path.abspath(root), os.path.abspath(out_path)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from diffphore_torch.cli.pipeline import FitEngine, job_from_cached
    from diffphore_torch.data.graphs import concat_batches
    from diffphore_torch.data.transforms import draw_noise
    from diffphore_torch.models.layers import set_compute_dtype
    from diffphore_torch.ops import build
    from diffphore_torch.sampler.sampling import SamplerSettings
    from diffphore_torch.train.state import create_train_state, make_train_step
    from diffphore_torch.utils.checkpoints import load_model_dir

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(["tp_fused", "tp_aggregate", "tp_scalar"])
    out = {}
    cfg, model = load_model_dir(cs.MODEL_DIR, device="cuda")
    complexes = [b for _, b in cs.bucket_complexes(cs.CACHE_DIR, 2)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    batch = cs.posed_rows(complexes[0].to("cuda"), cs.POSES, cfg, gen)
    with torch.inference_mode():
        for dt in ("bfloat16", "float32"):
            set_compute_dtype(model, dt)
            for i, o in enumerate(model(batch, pose_group=cs.POSES)):
                out[f"fwd_{dt}_{i}"] = o.float().cpu()
    set_compute_dtype(model, cfg.compute_dtype)
    train_batch = concat_batches([b for _, b in cs.bucket_complexes(cs.TRAIN_CACHE_DIR, 24)]
                                 ).replace(names=(), meta=()).to("cuda")
    gen.manual_seed(0)
    draws = draw_noise(24, train_batch.num_torsions, gen, "cuda")
    state = create_train_state(cfg, seed=0, device="cuda")
    drop = torch.Generator(device="cuda")
    drop.manual_seed(1)
    state, metrics = make_train_step(cfg)(state, train_batch, drop, draws=draws)
    out["loss"] = metrics["loss"].float().cpu()
    for k, p in state.model.named_parameters():
        out["grad_" + k] = p.grad.float().cpu()
    engine = FitEngine(cfg, model, samples_per_complex=cs.POSES,
                       settings=SamplerSettings(inference_steps=cs.STEPS), seed=0, device="cuda")
    (res,) = engine.run_complexes([job_from_cached(complexes[1])])
    out["poses"] = torch.as_tensor(res["poses"])
    torch.save(out, out_path)
    print(f"{root}: {len(out)} tensors -> {out_path}")


def compare(a_path: str, b_path: str) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    if set(a) != set(b):
        print(f"the two files hold other tensors: {sorted(set(a) ^ set(b))[:10]}")
        return 1
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    print(f"{len(a)} tensors compared, {len(diff)} differ: {diff[:10]}")
    if diff:
        rel = lambda k: float((a[k] - b[k]).abs().max()) / max(float(a[k].abs().max()), 1e-30)
        grads = [k for k in a if k.startswith("grad_") and a[k].numel()]
        flat = lambda d: torch.cat([d[k].flatten() for k in grads])
        print("max |a - b| / max|a|: " + ", ".join(
            f"{k} {rel(k):.2e}" for k in diff if not k.startswith("grad_"))
            + f"; the gradient as one vector, L2 |a - b| / |a| "
            f"{float((flat(a) - flat(b)).norm()) / float(flat(a).norm()):.2e}")
    return int(bool(diff))


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    save(sys.argv[1], sys.argv[2])

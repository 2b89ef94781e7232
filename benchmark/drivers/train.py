"""Training cells: the program's Trainer.step in a loop.

Set-up builds one Trainer and its state from the seed, and drives it
through the first `check_steps` steps with the window's own call and feed
(token batches drawn on the device from the seed, every row different),
reading what the comparison needs on the way: each step's loss, the norm
of every leaf's first gradient as AdamW took it (its first moment over
1 - b1), and the norm of every leaf's change once those steps are done
(against the initial state worked out again from the seed). The same
state then runs the window. After it the state is freed and the plain
reference runs the same steps on the same batches.

Traced runs profile up to MAX_TRACED steps of the window instead.
"""

from __future__ import annotations

import gc
import math
import time

MAX_TRACED = 5
FAULTS = ("unchanged", "half_batch")


def _leaves(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _pieces(t):
    """A stacked leaf [L, ...] slice by slice, any other leaf whole: no
    float32 copy of a whole large leaf at once."""
    return t if t.dim() >= 3 else [t]


def _norm(t) -> float:
    """sqrt of the sum of squares, accumulated in float64."""
    import torch
    with torch.no_grad():
        return math.sqrt(sum(float(x.float().norm()) ** 2
                             for x in _pieces(t)))


def _change(params: dict, spec, seed: int, device) -> dict:
    """{leaf: norm of (params - the initial leaf drawn from seed)}."""
    import torch

    from reference import init_recipe
    out = {}
    with torch.no_grad():
        for path, p0 in init_recipe.leaves(spec, seed, device):
            out[path] = math.sqrt(sum(
                float((a.float() - b.float()).norm()) ** 2
                for a, b in zip(_pieces(params[path]), _pieces(p0))))
            del p0
    return out


def _optimizer(traffic: dict):
    from reference.decoder import AdamW
    return AdamW(**traffic["optimizer"])


def _host_moments(mu: dict) -> dict:
    """A host copy of first moments, {leaf: tensor}: what the first step
    left in the optimizer's state."""
    return {p: t.detach().to("cpu", copy=True) for p, t in mu.items()}


def _reference_run(spec, seed: int, batches: list, opt, device,
                   precision: str, judged_mu=None) -> dict:
    """The reference's readings over `batches`, from the seeded state. With
    judged_mu (a host copy of the judged side's first moments after step
    1), also each leaf's norm of (its first gradient, mu / (1 - b1), less
    the reference's) as "first_diff"; the judged side's own first moments
    come back under "mu" when there is nothing to judge."""
    from reference import decoder, init_recipe
    params = init_recipe.params(spec, seed, device)
    diff: dict = {}
    kept: dict = {}

    def probe(path, i, g):
        theirs = judged_mu[path] if i is None else judged_mu[path][i]
        d = theirs.to(g.device).float() / (1 - opt.b1) - g
        diff[path] = diff.get(path, 0.0) + float((d * d).sum())

    out = decoder.train_steps(
        params, batches, spec, opt, precision,
        probe=probe if judged_mu is not None else None,
        after_first=(lambda mu: kept.update(_host_moments(mu)))
        if judged_mu is None else None)
    change = _change(params, spec, seed, device)
    del params
    res = {"loss": out["loss"], "first_grads": out["first_grads"],
           "change": change}
    if judged_mu is not None:
        res["first_diff"] = {p: math.sqrt(v) for p, v in diff.items()}
    else:
        res["mu"] = kept
    return res


def run(c, seed: int, seconds: float, trace: bool, device: str, t0: float,
        fault: str = "", control: bool = False) -> dict:
    import torch

    import devtrace
    import flops
    from reference import compare, decoder
    from reference.spec import from_dict

    spec = from_dict(c.config, c.config_name)
    tr = c.traffic
    b, s, n_check = tr["batch"], tr["seq"], tr["check_steps"]
    opt = _optimizer(tr)
    wseed, dseed = seed, (seed * 1_000_003 + 7) % 2 ** 63
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if fault and fault not in FAULTS:
        raise ValueError(f"fault {fault!r} not in {FAULTS}")

    gen = torch.Generator(device=dev).manual_seed(dseed)

    def feed():
        return torch.randint(0, spec.vocab, (b, s), generator=gen,
                             device=dev)

    batches: list = []
    steps = attempted = failed = 0
    window = 0.0
    summary = None
    check_s = 0.0
    if control:
        # the reference in float8 stands where the program runs
        batches = [feed() for _ in range(n_check)]
        prog = _reference_run(spec, wseed, batches, opt, dev, "fp8")
        judged_mu = prog.pop("mu")
        setup_s = time.perf_counter() - t0
        peak = 0
    else:
        from gpu_docker_api_tpu_torch.ops import attention as att
        from gpu_docker_api_tpu_torch.train import TrainConfig, Trainer

        from program import port_config
        cfg = port_config(spec)
        tc = TrainConfig(learning_rate=opt.lr, weight_decay=opt.weight_decay,
                         b1=opt.b1, b2=opt.b2, grad_clip=opt.clip,
                         remat=tr["remat_policy"] != "none",
                         remat_policy=tr["remat_policy"])
        trainer = Trainer.create(cfg, tc=tc, device=dev)
        state = trainer.init(seed=wseed)
        if fault == "unchanged":
            trainer.optimizer.update = lambda *a, **k: None

        def step(tokens):
            if fault == "half_batch":
                tokens = tokens[:b // 2] if b > 1 else tokens[:, :s // 2]
            _, m = trainer.step(state, tokens)
            return m["loss"]

        losses, first = [], {}
        for i in range(n_check):
            tokens = feed()
            batches.append(tokens.clone())
            losses.append(float(step(tokens)))
            if i == 0:
                tick = time.perf_counter()
                mu = _leaves(state["opt_state"]["mu"])
                first = {p: _norm(m) / (1 - opt.b1) for p, m in mu.items()}
                judged_mu = _host_moments(mu)
                del mu
                check_s += time.perf_counter() - tick
        tick = time.perf_counter()
        prog = {"loss": losses, "first_grads": first,
                "change": _change(_leaves(state["params"]), spec, wseed, dev)}
        check_s += time.perf_counter() - tick
        if on_card:
            torch.cuda.synchronize(dev)
        setup_s = time.perf_counter() - t0 - check_s

        window_losses = []
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if on_card else [])
            att.reset_launches()
            with profile(activities=acts) as prof:
                with record_function(devtrace.WINDOW):
                    start = time.perf_counter()
                    while (steps < MAX_TRACED
                           and time.perf_counter() - start < seconds):
                        window_losses.append(step(feed()))
                        steps += 1
                    if on_card:
                        torch.cuda.synchronize(dev)
            window = time.perf_counter() - start
            summary = devtrace.from_profiler(prof)
            summary.update(
                kind="train", steps=steps, launches=dict(att.LAUNCHES),
                attention={"batch": b, "seq": s, "heads": spec.n_heads,
                           "kv_heads": spec.n_kv_heads,
                           "head_dim": spec.head_dim, "window": spec.window},
                step_flops=flops.train_step_flops(spec, b, s),
                moe=spec.moe)
        else:
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                window_losses.append(step(feed()))
                steps += 1
            if on_card:
                torch.cuda.synchronize(dev)
            window = time.perf_counter() - start
        attempted = steps
        failed = sum(1 for x in window_losses if not math.isfinite(float(x)))
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        del state, trainer, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    decoder.pin_f32()
    tick = time.perf_counter()
    ref = _reference_run(spec, wseed, batches, opt, dev, "f32", judged_mu)
    ref_s = time.perf_counter() - tick
    del judged_mu
    numbers = compare.train_numbers(prog, ref)
    e2e = {}
    if steps and not trace:
        e2e["train_tokens_per_s"] = steps * b * s / window
    e2e["setup_s"] = setup_s
    return {"attempted": attempted, "failed": failed, "e2e": e2e,
            "summary": summary, "numbers": numbers,
            "readings": {"program": prog, "reference": ref},
            "timing": {"setup_s": setup_s, "window_s": window,
                       "check_s": check_s, "reference_s": ref_s},
            "memory_peak_bytes": peak}

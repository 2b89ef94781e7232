"""PyTorch port, ops/optim.py: the gradient norm's sum of squares and the
AdamW update. On the CPU: the wrappers run the plain versions, the update
never reads the norm on the host, the bf16 update rounds once, and the
module imports with no CUDA toolkit. On the card (marker `card`, skipped
without one; `python -m pytest -m card tests/test_torch_optim.py`): each
kernel against its plain version at the working dtype, and the Trainer's
step through the kernels alone."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpu_docker_api_tpu_torch import _build
from gpu_docker_api_tpu_torch import train as ttrain
from gpu_docker_api_tpu_torch.models import llama as tllama
from gpu_docker_api_tpu_torch.ops import optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYPER = dict(clip=1.0, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
EMBED = 32000 * 4096        # Mistral-7B's embed: 131 M elements


def _bc(count):
    """1 - b**count in f32, as AdamW.update takes them."""
    bc1, bc2 = ttrain.bias_corrections(ttrain.TrainConfig(), count)
    return {"bc1": bc1, "bc2": bc2}


def _leaf(n, dtype, seed, device="cpu", scale=0.02):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (scale * torch.randn(n, generator=gen, device=device)).to(dtype)


@pytest.fixture
def no_kernel(monkeypatch):
    """Any attempt to load a kernel library fails the test."""
    def refuse(name):
        raise AssertionError(f"kernel {name} loaded for CPU tensors")
    monkeypatch.setattr(_build, "library", refuse)
    optim.reset_launches()
    yield
    assert optim.LAUNCHES == dict.fromkeys(optim.LAUNCHES, 0)


# ---- CPU --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_versions(no_kernel, dtype):
    leaves = [_leaf(n, dtype, seed=n) for n in (1, 33, 4097)]
    want = sum(float((t.double() ** 2).sum()) for t in leaves)
    got = optim.sum_squares(leaves)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-6)
    assert torch.equal(got, optim.sum_squares_plain(leaves))
    p, g = _leaf(4097, dtype, 1), _leaf(4097, dtype, 2, scale=1.0)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    twin = [t.clone() for t in (p, g, mu, nu)]
    norm = torch.tensor(50.0)
    optim.adamw(p, g, mu, nu, norm, lr=3e-4, **HYPER, **_bc(1))
    optim.adamw_plain(*twin, norm, lr=3e-4, **HYPER, **_bc(1))
    for a, b in zip((p, g, mu, nu), twin):
        assert torch.equal(a, b)


def test_the_ops_refuse_tensors_on_two_devices():
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="all on the CPU or all on one"):
        optim.sum_squares([x, torch.zeros(4, device="meta")])
    with pytest.raises(ValueError, match="all on the CPU or all on one"):
        optim.adamw(x, x, x, x, torch.zeros((), device="meta"), lr=1e-3,
                    **HYPER, **_bc(1))


class _NoHostRead(torch.Tensor):
    """A norm the host may not read: the update must decide the clip on
    the device."""

    def __bool__(self):
        raise AssertionError("the update read the norm on the host (bool)")

    def item(self):
        raise AssertionError("the update read the norm on the host (item)")

    def __float__(self):
        raise AssertionError("the update read the norm on the host (float)")

    def tolist(self):
        raise AssertionError("the update read the norm on the host (tolist)")


@pytest.mark.parametrize("norm", [50.0, 0.5])
def test_adamw_update_takes_no_host_read_of_the_norm(norm):
    """Clip on (norm 50x the clip) and off: the update runs with a norm
    whose host reads raise, and equals the one with a plain norm."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 6), "n": (6,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in shapes.values()]
    twin = {k: v.clone() for k, v in params.items()}
    out = []
    for tree, n in ((params, torch.tensor(norm).as_subclass(_NoHostRead)),
                    (twin, torch.tensor(norm))):
        adam = ttrain.AdamW(ttrain.TrainConfig(warmup_steps=2))
        state = adam.init(tree)
        for _ in range(2):
            adam.update(grads, state, list(tree.values()), n)
        out.append(tree)
    for k in shapes:
        assert torch.equal(out[0][k], out[1][k]), k


def test_plain_bf16_update_rounds_once():
    """A bf16 leaf's update is the f32 update of the same values, rounded
    once to bf16 at its store: no operation rounds to bf16 on the way."""
    p = _leaf(4097, torch.bfloat16, 4)
    g = _leaf(4097, torch.bfloat16, 5, scale=1.0)
    mu = _leaf(4097, torch.bfloat16, 6, scale=1e-2)
    nu = _leaf(4097, torch.bfloat16, 7, scale=1e-2).abs()
    wide = [t.float() for t in (p, g, mu, nu)]
    norm = torch.tensor(50.0)
    optim.adamw_plain(p, g, mu, nu, norm, lr=3e-4, **HYPER, **_bc(3))
    optim.adamw_plain(*wide, norm, lr=3e-4, **HYPER, **_bc(3))
    for got, want in zip((p, mu, nu), (wide[0], wide[2], wide[3])):
        assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("dtype,ulps_in,ulps_out", [
    (torch.float32, 8, 16), (torch.bfloat16, 1, 2)])
def test_kernel_gap_tolerance_is_in_the_leafs_own_ulps(dtype, ulps_in,
                                                        ulps_out):
    """An f32 result may stray 8 f32 ulps and a bf16 one 1 bf16 ulp, no
    more; where p cancels (the result far under p), 8 f32 ulps of p."""
    bits = 23 if dtype == torch.float32 else 7
    want = torch.tensor([0.75, -1.5, 3.0]).to(dtype)
    ulp = torch.tensor([2.0 ** (e - bits) for e in (-1, 0, 1)])
    for k, bad in ((ulps_in, 0), (ulps_out, 3)):
        got = (want.float() + k * ulp).to(dtype)
        assert optim.kernel_gap(got, want, want) == bad, k
    before, small, near, far = (torch.tensor([x]).to(dtype) for x in (
        1.0, 2.0 ** -20, 2.0 ** -19, 3 * 2.0 ** -20))
    assert optim.kernel_gap(near, small, before) == 0
    assert optim.kernel_gap(far, small, before) == 1


def test_optim_imports_with_no_cuda_toolkit(tmp_path):
    """The module builds nothing at import: it imports where no nvcc is on
    the PATH, loads no library, and only a launch would ask for nvcc."""
    code = ("import torch\n"
            "from gpu_docker_api_tpu_torch import _build, train\n"
            "from gpu_docker_api_tpu_torch.ops import optim\n"
            "assert not _build._loaded\n"
            "x = [torch.ones(3)]\n"
            "assert float(optim.sum_squares(x)) == 3.0\n"
            "assert not _build._loaded\n"
            "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PATH=str(tmp_path),
                                  PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported"


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _within_tolerance(got, want, before, label):
    """Kernel against plain, within optim.kernel_gap's tolerance: 1 ulp of
    the dtype at the result, or 8 f32 ulps where the update's f32 rounding
    shows (its docstring has the reason)."""
    bad = optim.kernel_gap(got, want, before)
    assert bad == 0, f"{label}: {bad} elements past the tolerance, worst " \
                     f"{float((got.float() - want.float()).abs().max())}"


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 4097, EMBED])
@pytest.mark.parametrize("norm", [50.0, 0.5], ids=["clip", "no_clip"])
def test_adamw_kernel_matches_plain(card, dtype, n, norm):
    """Counts 1 to 3 under a warmup / cosine schedule: each update from the
    same state, through the kernel and the plain version."""
    schedule = ttrain.make_schedule(ttrain.TrainConfig(
        learning_rate=3e-4, warmup_steps=2, decay_steps=4))
    p = _leaf(n, dtype, 1, card)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    nrm = torch.tensor(norm, device=card)
    optim.reset_launches()
    for count in range(3):
        g = _leaf(n, dtype, 10 + count, card, scale=1.0)
        kw = dict(lr=schedule(count), **HYPER, **_bc(count + 1))
        twin = [t.clone() for t in (p, g, mu, nu)]
        before = [t.clone() for t in (p, mu, nu)]
        optim.adamw(p, g, mu, nu, nrm, **kw)
        optim.adamw_plain(*twin, nrm, **kw)
        torch.cuda.synchronize()
        for name, got, want, old in zip(("p", "mu", "nu"), (p, mu, nu),
                                        (twin[0], twin[2], twin[3]), before):
            _within_tolerance(got, want, old, f"{name} at count {count + 1}")
        assert torch.equal(g, twin[1])
    assert optim.LAUNCHES["adamw"] == 3


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_adamw_kernel_unaligned_leaf_takes_the_scalar_path(card, dtype):
    """Views one element into their storage (not 16-byte aligned)."""
    base = [_leaf(4098, dtype, s, card, scale) for s, scale in
            ((1, 0.02), (2, 1.0), (3, 1e-2), (4, 1e-2))]
    base[3] = base[3].abs()
    twin = [t.clone() for t in base]
    before = [t.clone() for t in base]
    kw = dict(lr=3e-4, **HYPER, **_bc(2))
    nrm = torch.tensor(50.0, device=card)
    optim.adamw(*(t[1:] for t in base), nrm, **kw)
    optim.adamw_plain(*(t[1:] for t in twin), nrm, **kw)
    for got, want, old in zip(base, twin, before):
        _within_tolerance(got, want, old, "unaligned")
        assert torch.equal(got[:1], want[:1])


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_adamw_kernel_applies_the_weight_decay(card, dtype):
    """g = 0 and fresh moments leave u = weight_decay p alone: at
    lr weight_decay = 0.05 the decay moves every nonzero p by 5%, far past
    the tolerance, so a kernel that drops the term fails here."""
    p = _leaf(4097, dtype, 40, card)
    g, mu, nu = (torch.zeros_like(p) for _ in range(3))
    twin = [t.clone() for t in (p, g, mu, nu)]
    before = p.clone()
    kw = dict(HYPER, lr=0.1, weight_decay=0.5, **_bc(1))
    optim.adamw(p, g, mu, nu, torch.tensor(0.5, device=card), **kw)
    optim.adamw_plain(*twin, torch.tensor(0.5, device=card), **kw)
    _within_tolerance(p, twin[0], before, "p")
    moved = optim.kernel_gap(twin[0], before, before)
    assert moved == int((before != 0).sum()), moved
    assert not mu.any() and not nu.any()


@pytest.mark.card
def test_adamw_kernel_empty_leaf_launches_nothing(card):
    e = torch.zeros(0, device=card)
    optim.reset_launches()
    optim.adamw(e, e, e, e, torch.tensor(1.0, device=card), lr=1e-3,
                **HYPER, **_bc(1))
    assert optim.LAUNCHES == dict.fromkeys(optim.LAUNCHES, 0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 4097, EMBED])
def test_sum_squares_kernel_matches_an_f64_sum(card, dtype, n):
    """Within 1e-5 relative of the f64 sum (f32 squares, each thread's
    sum in f32 over at most a few hundred 16-byte vectors, the partials
    added in f64), and the same bits on a second call."""
    x = _leaf(n, dtype, 20, card, scale=1.0)
    want = float((x.double() ** 2).sum())
    optim.reset_launches()
    got = optim.sum_squares([x])
    assert got.dtype == torch.float32 and got.device == x.device
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert torch.equal(got, optim.sum_squares([x]))
    assert optim.LAUNCHES == {"adamw": 0, "sum_squares": 2,
                              "sum_partials": 2}


@pytest.mark.card
def test_sum_squares_kernel_over_mixed_leaves(card):
    """bf16 and f32 leaves in one call, one of them unaligned, one empty:
    a launch a non-empty leaf, one over the partials."""
    leaves = [_leaf(4097, torch.bfloat16, 30, card, 1.0),
              _leaf(4096, torch.float32, 31, card, 1.0),
              _leaf(4098, torch.bfloat16, 32, card, 1.0)[1:], torch.zeros(
                  0, device=card)]
    want = sum(float((t.double() ** 2).sum()) for t in leaves)
    optim.reset_launches()
    assert float(optim.sum_squares(leaves)) == pytest.approx(want, rel=1e-5)
    assert optim.LAUNCHES == {"adamw": 0, "sum_squares": 3,
                              "sum_partials": 1}


@pytest.mark.card
@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_step_runs_the_kernels_once_per_leaf_and_norm(
        card, monkeypatch, accum):
    def plain(*a, **k):
        raise AssertionError("a CUDA step took a plain version")
    monkeypatch.setattr(optim, "adamw_plain", plain)
    monkeypatch.setattr(optim, "sum_squares_plain", plain)
    cfg = tllama.LlamaConfig.tiny()
    tr = ttrain.Trainer.create(cfg, tc=ttrain.TrainConfig(accum_steps=accum),
                               device="cuda")
    state = tr.init(seed=0)
    n_leaves = len(ttrain.tree_leaves(state["params"]))
    toks = torch.randint(0, cfg.vocab_size, (4, 32),
                         generator=torch.Generator().manual_seed(0))
    optim.reset_launches()
    for step in range(1, 3):
        state, m = tr.step(state, tr.shard_batch(toks))
        assert optim.LAUNCHES == {"adamw": step * n_leaves,
                                  "sum_squares": step * n_leaves,
                                  "sum_partials": step}
    assert torch.isfinite(m["loss"]) and float(m["grad_norm"]) > 0

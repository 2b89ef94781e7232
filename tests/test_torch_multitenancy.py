"""The port's fractional card shares against the JAX package's: every case
of tests/test_multitenancy.py, run on both packages
(tests/torch_lifecycle_twins.py says what is recorded, and
tests/torch_fleet_twins.py how it is compared and what is normalised):
the share ledger (packing, concurrent grants without oversubscription,
whole and fractional grants mixed, owner-checked release, its round trip
through the store, cordons), the service's grant lifecycle, a co-tenant
drain with zero leaked shares, a crash mid-replace that reconciles the
ledger, the per-card regulator (weighted sharing, latency preemption with
a bounded stall, duplicate names, the registry), the batcher's ticks
through the regulator, and the REST surface: fractional runs, /metrics'
shares and the preempt event. Both variants grant on a line of cards
(v4-16 reads as h100-8, v4-32 as h100-16), and the port's grant env is
read as the card's (CUDA_VISIBLE_DEVICES where JAX's names
TPU_VISIBLE_CHIPS).

In the crash-mid-replace case each write-behind write lands before the
code that queued it goes on (the reconcile's report otherwise depends on
how the queue's thread interleaves with it). Where a JAX case sleeps a
fixed time for its holder thread to be inside its slice, the twin waits
for that state (the regulator's holder is the
best-effort tenant; tests/torch_app_twins.py UNTIL), so the latency
tenant's arrival lands mid-chunk however loaded the host; the bounded-
stall assertion is JAX's as written.

The batcher case runs the port's _Batcher (workloads/serve.py) at `tiny`
on the weights of JAX's init (convert.params_from_numpy), and its four
greedy streams must equal the JAX batcher's."""

import torch

from torch_lifecycle_twins import twin_tests
from torch_app_twins import UNTIL

torch.set_num_threads(1)

HOLDER_MID_CHUNK = "_until(lambda: reg._holder is be)"

PATCHES = (
    # a crash mid-replace, then the reconcile: both write through the
    # write-behind queue and read the store, so what the reconcile finds
    # (its versionFixes) is the queue thread's race with the caller's; in
    # the twin each queued write lands before the caller goes on
    ("    rs, backend, tpu, wq, client = world\n",
     "    rs, backend, tpu, wq, client = world\n"
     "    _submit = wq.submit\n\n"
     "    def _landed(msg):\n"
     "        _submit(msg)\n"
     "        wq.join()\n"
     "    wq.submit = _landed\n"),
    # the grant's card env (tests/test_torch_services.py's mapping)
    ('    assert st.spec.tpu_env.get("TPU_VISIBLE_CHIPS")',
     '    assert st.spec.tpu_env.get("CUDA_VISIBLE_DEVICES")', "torch"),
    ("    time.sleep(0.01)                    # holder mid-chunk",
     f"    {HOLDER_MID_CHUNK}  # holder mid-chunk"),
    ("    th.start()\n    time.sleep(0.005)\n",
     f"    th.start()\n    {HOLDER_MID_CHUNK}\n"),
    # the port's batcher on JAX's init of the same config
    ("        params = init_params(config, jax.random.key(0))",
     "        import numpy as np\n"
     "        from gpu_docker_api_tpu.models import llama as jllama\n"
     "        from gpu_docker_api_tpu_torch import convert\n"
     "        params = convert.params_from_numpy(jax.tree.map(\n"
     "            np.asarray, jllama.init_params(jllama.LlamaConfig.tiny(),\n"
     "                                           jax.random.key(0))), config)",
     "torch"),
    ("            prompt = jnp.ones((8,), jnp.int32)",
     "            import torch\n"
     "            prompt = torch.ones(8, dtype=torch.long)", "torch"),
    # the four greedy streams: JAX's kept, the port's held to them
    ("            assert all(len(o) == 12 for o in outs)\n",
     "            assert all(len(o) == 12 for o in outs)\n"
     "            import torch_lifecycle_twins as _lt\n"
     "            _lt.STREAMS['batcher'] = sorted(\n"
     "                [int(x) for x in o] for o in outs)\n", "jax"),
    ("            assert all(len(o) == 12 for o in outs)\n",
     "            assert all(len(o) == 12 for o in outs)\n"
     "            import torch_lifecycle_twins as _lt\n"
     "            assert sorted([int(x) for x in o] for o in outs) \\\n"
     "                == _lt.STREAMS.pop('batcher')\n", "torch"),
)

globals().update(twin_tests("test_multitenancy", patches=PATCHES,
                            extra=UNTIL))

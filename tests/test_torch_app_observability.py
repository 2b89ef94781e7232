"""The port's daemon against the JAX App on the observability sweep: every
case of tests/test_observability.py (traces from ingress to the store,
traceparent, error envelopes carrying the trace id, crash stitching by the
reconciler, SSE follow / resume / heartbeats, /metrics as Prometheus text,
the histogram and label arithmetic, and the rotating writers), run on both
packages and held envelope by envelope (tests/torch_app_twins.py says how,
and what is normalised)."""

import torch

from torch_app_twins import UNTIL, twin_tests

torch.set_num_threads(1)

# where the JAX cases sleep for an SSE follower to attach, the twins wait
# until the App counts it (tests/torch_app_twins.py UNTIL)
PATCHES = (
    ("    time.sleep(0.3)       # let the stream attach (subscribe-from-now)\n",
     "    _until(lambda: app._stream_clients >= 1)   # the stream attached\n"),
    ("    conn, resp = sse_connect(app)          # default heartbeat (15s)\n"
     "    time.sleep(0.2)\n",
     "    conn, resp = sse_connect(app)          # default heartbeat (15s)\n"
     "    _until(lambda: app._stream_clients == 1)\n"),
)

globals().update(twin_tests("test_observability", patches=PATCHES,
                            extra=UNTIL))


def test_every_telemetry_name_of_the_port_is_in_its_catalog():
    """The port's obs/names.py is JAX's catalog, and tdlint's untraced-op
    rule holds over the port's sources against it: every event op literal
    the port records and every tdapi_* family it declares is registered
    (a planted unregistered op is caught)."""
    import ast
    import os

    from gpu_docker_api_tpu.obs import names as jnames
    from gpu_docker_api_tpu_torch.obs import names as tnames
    from tools.tdlint import FileCtx
    from tools.tdlint.rules import UntracedOp

    assert (tnames.EVENT_OPS, tnames.METRIC_NAMES) == (jnames.EVENT_OPS,
                                                       jnames.METRIC_NAMES)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = os.path.join(repo, "gpu_docker_api_tpu_torch")
    ctxs = [FileCtx.load(os.path.join(d, f), repo)
            for d, _, files in os.walk(port) for f in files
            if f.endswith(".py")]
    rule = UntracedOp()
    assert rule.check_files(ctxs, scoped=False) == []
    planted = FileCtx(path="x.py", rel="x.py", text="",
                      tree=ast.parse('events.record("no.such.op")'))
    assert [v.rule for v in rule.check_files(ctxs + [planted],
                                             scoped=False)] == [rule.name]

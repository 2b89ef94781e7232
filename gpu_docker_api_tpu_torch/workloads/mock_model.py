"""Mock model replica — the serving contract without the accelerator.

The port's copy of the JAX package's workloads/mock_model.py (stdlib
only); `launch_cmd` starts the port's module.

Speaks exactly the serving workload's HTTP surface (workloads/serve.py:
`GET /healthz` with the `batching` block, `POST /generate` with the
token-level envelope, the `X-TDAPI-*` admission headers), but the "model"
is a slot-bounded hold of --decode-ms per request instead of a model's
decode loop. Exists so the GATEWAY control loop — routing, admission,
shedding, autoscale, clone-warm starts — can be exercised and priced
end-to-end over real processes and real HTTP without importing torch
per replica (stdlib only: the warm pool absorbs the interpreter, so a
router-overhead number prices the gateway, not the model).

Warm-start contract (the CoW-clone story): startup costs
--init-ms once — simulating model load + first compile — then writes
--warm-mb of "weights" plus a `.model_ready` marker into the writable
layer. A replica whose layer was CLONED from a warm donor (gateway
scale-up) finds the marker and skips the init cost entirely: ready in
milliseconds, the same economics as a real replica inheriting its
donor's checkpoint/compile cache.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import faults, kvaffinity

READY_MARKER = ".model_ready"

#: simulated prefix store capacity (distinct prompts whose "KV" is warm)
PREFIX_CAP = 32


def launch_cmd(repo_root: str, *args: str) -> list:
    """Container cmd that launches this module from `repo_root` on any
    cwd (the process substrate chdirs into the container rootfs before
    exec, so a bare `-m` lookup would miss the repo). The `-c` form is
    warm-pool-eligible and needs no PYTHON* env (which would force a
    cold spawn — backend/warmpool.py supports())."""
    import sys
    code = (f"import sys; sys.path.insert(0, {repo_root!r}); "
            "from gpu_docker_api_tpu_torch.workloads.mock_model import main; "
            f"raise SystemExit(main({list(args)!r}))")
    return [sys.executable, "-u", "-c", code]


class _State:
    def __init__(self, slots: int, decode_ms: float, admit_queue: int,
                 prefill_token_ms: float = 0.0, kv_ttl: float = 30.0):
        self.slots = slots
        self.decode_ms = decode_ms
        self.admit_queue = admit_queue
        self.lock = threading.Lock()
        self.slot_sem = threading.Semaphore(slots)
        self.active = 0
        self.queued = 0
        self.served = 0
        self.shed = 0
        # KV serving contract (serve.py's paged-batcher surface):
        # a bounded LRU of prompt tuples stands in for the prefix trie —
        # a request whose prompt extends a stored tuple skips that many
        # tokens of simulated prefill, which is what makes affinity
        # routing MEASURABLE over mocks (an affinity A/B's lever)
        self.prefill_token_ms = prefill_token_ms
        self.kv_ttl = kv_ttl
        self.prefixes: OrderedDict = OrderedDict()   # prompt tuple -> True
        self.sketch_hex = kvaffinity.encode_sketch_hex(
            [0] * kvaffinity.SKETCH_WORDS)
        self.kv_exports: dict = {}    # key -> {"tokens": [...], "at": t}
        self.kv_fetches = 0
        self.handoffs_in = 0
        self.prefix_hits = 0
        self.qwait_ewma: float | None = None

    # -- prefix store (call under self.lock) --

    def store_prefix(self, row: tuple) -> None:
        self.prefixes.pop(row, None)
        self.prefixes[row] = True
        while len(self.prefixes) > PREFIX_CAP:
            self.prefixes.popitem(last=False)
        hashes: list = []
        for key in self.prefixes:
            hashes.extend(kvaffinity.chunk_hashes(key))
        self.sketch_hex = kvaffinity.encode_sketch_hex(
            kvaffinity.build_sketch(hashes))

    def prefix_hit(self, row: tuple) -> int:
        """Longest stored-prompt prefix of `row`, floored to whole
        chunks — the serve.py block-floor analogue."""
        best = 0
        for key in self.prefixes:
            if len(key) > best and row[:len(key)] == key:
                best = len(key)
        if best == len(row) and best > 0:
            best -= 1     # last position always recomputes (real logits)
        return (best // kvaffinity.CHUNK_TOKENS) * kvaffinity.CHUNK_TOKENS

    def purge_exports(self) -> None:
        now = time.monotonic()
        for k in [k for k, v in self.kv_exports.items()
                  if now - v["at"] > self.kv_ttl]:
            del self.kv_exports[k]


def _fetch_kv(source: str, key: str) -> "list | None":
    """Decode side of the mock handoff: pull a peer mock's /kv export.
    Returns the exported prompt token list, or None on ANY failure —
    same degrade-to-full-prefill contract as serve.py's _fetch_kv."""
    from http.client import HTTPConnection
    try:
        host, _, port = source.rpartition(":")
        conn = HTTPConnection(host or "127.0.0.1", int(port), timeout=5)
        try:
            conn.request("GET", "/kv?key=" + key)
            payload = json.loads(conn.getresponse().read() or b"{}")
        finally:
            conn.close()
        if payload.get("code") != 200:
            return None
        toks = (payload.get("data") or {}).get("tokens")
        return list(toks) if isinstance(toks, list) and toks else None
    # tdlint: disable=silent-swallow -- a failed fetch degrades to full prefill by contract
    except Exception:  # noqa: BLE001
        return None


def _handler_for(st: _State, model: str):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # headers and body flush as separate segments; Nagle would hold
        # the second until the gateway ACKs — per-request tens of ms
        disable_nagle_algorithm = True

        def log_message(self, *a):
            pass

        def _send(self, code: int, msg: str, data, status: int = 200,
                  extra: dict | None = None):
            payload = json.dumps(
                {"code": code, "msg": msg, "data": data}).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            # trace continuity, same as serve.py: echo the caller's
            # traceparent on every response
            tp = self.headers.get("traceparent")
            if tp:
                self.send_header("traceparent", tp)
            with st.lock:
                self.send_header("X-TDAPI-Slots", str(st.slots))
                self.send_header("X-TDAPI-Active", str(st.active))
                self.send_header("X-TDAPI-Queued", str(st.queued))
                # the serve.py KV-affinity advertisement: prefix sketch,
                # cached-prefix occupancy, and the smoothed queue wait
                self.send_header("X-TDAPI-KV-Sketch", st.sketch_hex)
                self.send_header("X-TDAPI-KV-Occ", str(len(st.prefixes)))
                if st.qwait_ewma is not None:
                    self.send_header("X-TDAPI-Queue-Wait-EWMA-Ms",
                                     str(round(st.qwait_ewma, 3)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path.startswith("/kv"):
                # prefill side of the disaggregated handoff: serve one
                # exported prompt-KV entry (single-take, TTL-purged)
                key = ""
                if "key=" in self.path:
                    key = self.path.split("key=", 1)[1].split("&", 1)[0]
                with st.lock:
                    st.purge_exports()
                    entry = st.kv_exports.pop(key, None)
                    if entry is not None:
                        st.kv_fetches += 1
                if entry is None:
                    self._send(404, "kv export not found", None,
                               status=404)
                    return
                self._send(200, "Success", {"tokens": entry["tokens"],
                                            "len": len(entry["tokens"]),
                                            "bufs": {}})
                return
            if self.path != "/healthz":
                self._send(404, "route not found", None)
                return
            with st.lock:
                st.purge_exports()
                batching = {
                    "slots": st.slots, "active": st.active,
                    "queued": st.queued, "alive": True,
                    "served": st.served, "shed": st.shed,
                    "queueWait": {"ewmaMs": st.qwait_ewma},
                    "prefixCache": {
                        "entries": len(st.prefixes),
                        "blocks": sum(len(k) for k in st.prefixes)
                        // max(kvaffinity.CHUNK_TOKENS, 1),
                        "hits": st.prefix_hits,
                        "kvExports": len(st.kv_exports),
                        "kvFetches": st.kv_fetches,
                        "handoffsIn": st.handoffs_in,
                        "sketch": st.sketch_hex,
                    },
                }
            self._send(200, "Success", {
                "model": model, "params": 0,
                "batching": batching,
            })

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, "route not found", None)
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                tokens = body["tokens"]
                max_new = int(body.get("max_new", 16))
                if max_new < 1:
                    raise ValueError("max_new must be >= 1")
            except (KeyError, TypeError, ValueError) as e:
                self._send(400, f"bad request: {e}", None)
                return
            # replica-side fault gate, keyed by this replica's name: the
            # tail-tolerance e2e arms TDAPI_FAULTS="<gw>r0.generate:
            # jitter:0.05" in ONE replica's env to make exactly that
            # replica gray (slow or flaky but alive) while its fleet
            # peers stay healthy
            try:
                faults.fault_gate(
                    os.environ.get("TDAPI_REPLICA", "replica")
                    + ".generate")
            except faults.InjectedFault as e:
                self._send(500, f"injected replica fault: {e}", None)
                return
            # disaggregated handoff contract (serve.py's): Phase:prefill
            # runs one token and exports the prompt "KV" under the key;
            # KV-Source pulls a peer's export and skips that prefill
            hdr_key = self.headers.get("X-TDAPI-KV-Key") or ""
            kv_src = self.headers.get("X-TDAPI-KV-Source") or ""
            phase = self.headers.get("X-TDAPI-Phase") or ""
            kv_key = ""
            imported = 0
            row = list(tokens[0]) if (tokens and isinstance(tokens[0],
                                                            list)) else None
            if hdr_key and row is not None:
                if phase == "prefill":
                    kv_key, max_new = hdr_key, 1
                elif kv_src:
                    fetched = _fetch_kv(kv_src, hdr_key)
                    # STRICT prefix only: the last prompt position must
                    # run for real (the decode row carries one extra
                    # token past the exported prompt)
                    if (fetched and len(fetched) < len(row)
                            and row[:len(fetched)] == fetched):
                        imported = len(fetched)
                        with st.lock:
                            st.handoffs_in += 1
            # replica-side admission: shed past the queue bound so the
            # gateway re-routes instead of stacking waiters here
            with st.lock:
                if st.queued >= st.admit_queue:
                    st.shed += 1
                    do_shed = True
                else:
                    st.queued += 1
                    do_shed = False
            if do_shed:
                self._send(429, "replica queue full", None,
                           extra={"Retry-After": "1",
                                  "X-TDAPI-Shed": "1"})
                return
            t_enq = time.monotonic()
            st.slot_sem.acquire()
            # slot-wait telemetry, the serve.py contract: a fronting
            # worker stitches this into its forward span
            wait_ms = (time.monotonic() - t_enq) * 1e3
            with st.lock:
                st.queued -= 1
                st.active += 1
                prev = st.qwait_ewma
                st.qwait_ewma = (wait_ms if prev is None
                                 else 0.2 * wait_ms + 0.8 * prev)
            try:
                # the "prefill": per-prompt-token cost, discounted by
                # the longest warm prefix (stored prompt or handed-off
                # KV) — the time affinity routing and disaggregation
                # actually save over this mock
                if st.prefill_token_ms > 0 and row is not None:
                    with st.lock:
                        hit = max(st.prefix_hit(tuple(row)), imported)
                        if hit > 0:
                            st.prefix_hits += 1
                    time.sleep(
                        (len(row) - hit) * st.prefill_token_ms / 1e3)
                # the "decode": hold a slot for decode_ms per request
                time.sleep(st.decode_ms / 1e3)
                out = [list(r) + list(range(max_new)) for r in tokens]
                with st.lock:
                    if row is not None:
                        st.store_prefix(tuple(row))
                    if kv_key:
                        st.purge_exports()
                        st.kv_exports[kv_key] = {
                            "tokens": list(row),
                            "at": time.monotonic()}
            finally:
                with st.lock:
                    st.active -= 1
                    st.served += 1
                st.slot_sem.release()
            self._send(200, "Success", {"tokens": out},
                       extra={"X-TDAPI-Queue-Wait-Ms":
                              str(round(wait_ms, 3))})

    return Handler


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=0,
                   help="0 = $PORT from the process substrate, else 8000")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--slots", type=int, default=4,
                   help="concurrent in-flight requests (the batcher slots "
                        "the gateway admits against)")
    p.add_argument("--decode-ms", type=float, default=5.0,
                   help="per-request slot hold time (the simulated decode)")
    p.add_argument("--admit-queue", type=int, default=32,
                   help="replica-side queue bound; past it /generate sheds "
                        "429 so the gateway re-routes")
    p.add_argument("--init-ms", type=float, default=0.0,
                   help="one-time startup cost (simulated model load + "
                        "compile) — SKIPPED when the writable layer "
                        "already holds the warm marker (a CoW clone from "
                        "a warm donor)")
    p.add_argument("--warm-mb", type=int, default=0,
                   help="'weights' bytes written at init (what the clone "
                        "actually moves)")
    p.add_argument("--prefill-token-ms", type=float, default=0.0,
                   help="per-prompt-token prefill cost; discounted by the "
                        "longest warm prefix (stored prompt or handed-off "
                        "KV) — makes affinity routing measurable")
    p.add_argument("--kv-ttl", type=float, default=30.0,
                   help="seconds an un-fetched /kv export survives before "
                        "the purge frees it")
    args = p.parse_args(argv)
    port = args.port or int(os.environ.get("PORT", "8000"))

    warm = os.path.exists(READY_MARKER)
    if not warm:
        if args.init_ms > 0:
            time.sleep(args.init_ms / 1e3)
        if args.warm_mb > 0:
            with open("model.weights", "wb") as f:
                f.write(os.urandom(1024) * args.warm_mb * 1024)
        with open(READY_MARKER, "w") as f:
            f.write(json.dumps({"initMs": args.init_ms}))
    print(f"mock model {'WARM (cloned layer)' if warm else 'cold init'} — "
          f"{args.slots} slots, {args.decode_ms}ms decode", flush=True)

    st = _State(args.slots, args.decode_ms, args.admit_queue,
                prefill_token_ms=args.prefill_token_ms,
                kv_ttl=args.kv_ttl)
    httpd = ThreadingHTTPServer((args.host, port),
                                _handler_for(st, "mock"))
    print(f"mock model serving on {args.host}:{httpd.server_address[1]}",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

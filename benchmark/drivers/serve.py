"""Serving cells: the program's HTTP server under open-loop traffic.

Set-up starts the server (serve_wrapper.py around the port's
workloads/serve.py, with the mix's server arguments) as a child process on
a free local port, waits for it to answer, and warms it with a burst of
requests drawn like the window's. The window then offers the mix's
requests at their due times, whether or not earlier ones have finished
(one scheduling thread, a pool of sender threads, greedy decoding). Each
request is timed from when it was due; one that is refused, fails or never
answers counts in `failed`. After the window every request due in it is
awaited (a minute at most), the server is stopped, and the plain reference
runs once over a sample of the finished requests, drawn from the seed
with the longest in it, each prompt with its served tokens. The server's
exit writes its peak allocation and the JAX modules it loaded, if any,
which the run passes up.
"""

from __future__ import annotations

import gc
import http.client
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

START_TIMEOUT_S = 900        # a first start may build and load for long
DRAIN_S = 60                 # how long past the window a request may take
TRACE_S = 4.0                # length of the traced part of a traced window
SENDERS = 64
TICK_S = 0.05


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def send(port: int, prompt: list, max_new: int, timeout: float) -> dict:
    """One greedy /generate; {"ok", "tokens", "queue_wait_ms", "error"}."""
    body = json.dumps({"tokens": [prompt], "max_new": max_new,
                       "temperature": 0.0})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/generate", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        wait = resp.getheader("X-TDAPI-Queue-Wait-Ms")
    except (OSError, ValueError, http.client.HTTPException) as e:
        return {"ok": False, "error": repr(e)}
    finally:
        conn.close()
    toks = ((data.get("data") or {}).get("tokens") or [[]])[0]
    ok = data.get("code") == 200 and len(toks) == max_new
    return {"ok": ok, "tokens": toks,
            "queue_wait_ms": float(wait) if wait is not None else None,
            "error": None if ok else str(data.get("msg"))}


class Server:
    """The child server process, its log and its output directory."""

    def __init__(self, c, trace: bool, device: str, fault: str = ""):
        self.dir = tempfile.mkdtemp(prefix="bench-serve-")
        self.port = _free_port()
        self.log_path = os.path.join(self.dir, "server.log")
        tr = c.traffic
        cmd = [sys.executable, os.path.join(c.bench_dir, "serve_wrapper.py"),
               "--bench-config", c.config_path,
               "--bench-name", c.config_name, "--bench-out", self.dir,
               "--bench-trace", str(int(trace))]
        if fault:
            cmd += ["--bench-fault", fault]
        cmd += ["--", *tr["server_args"], "--host", "127.0.0.1",
                "--port", str(self.port), "--device", device]
        self.log = open(self.log_path, "w", encoding="utf-8")
        self.proc = subprocess.Popen(cmd, stdout=self.log,
                                     stderr=subprocess.STDOUT, cwd=c.root,
                                     env=dict(os.environ))

    def wait_ready(self) -> None:
        deadline = time.monotonic() + START_TIMEOUT_S
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError("the server exited at start:\n"
                                   + self.tail())
            try:
                conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                                  timeout=5)
                conn.request("GET", "/healthz")
                if json.loads(conn.getresponse().read()).get("code") == 200:
                    return
            except (OSError, ValueError, http.client.HTTPException):
                pass
            time.sleep(0.25)
        raise RuntimeError("the server did not answer in time:\n"
                           + self.tail())

    def signal(self, sig) -> None:
        self.proc.send_signal(sig)

    def read(self, name: str, timeout: float = 300.0) -> dict:
        path = os.path.join(self.dir, name)
        deadline = time.monotonic() + timeout
        while not os.path.exists(path):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(f"the server wrote no {name}:\n"
                                   + self.tail())
            time.sleep(0.1)
        with open(path, encoding="utf-8") as f:
            return json.load(f)

    def stop(self) -> dict:
        """SIGINT, wait for the exit, and the stats it wrote."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()
        path = os.path.join(self.dir, "stats.json")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        return {}

    def tail(self, n: int = 4000) -> str:
        self.log.flush()
        with open(self.log_path, encoding="utf-8", errors="replace") as f:
            return f.read()[-n:]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.log.closed:
            self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def offer(port: int, reqs: list, seconds: float, on_window=None) -> tuple:
    """Open loop: each request sent at its due time from a pool of
    SENDERS threads. -> (records, window start on the monotonic clock).
    on_window(offset) is called from the scheduling thread at least every
    TICK_S of the window and once at its close."""
    records = [None] * len(reqs)
    start = time.monotonic() + 0.05

    def one(i, r, due):
        sent = time.monotonic()
        out = send(port, r["prompt"], r["max_new"],
                   timeout=seconds + DRAIN_S)
        out.update(due=due, sent=sent, done=time.monotonic())
        records[i] = out

    with ThreadPoolExecutor(max_workers=SENDERS) as pool:
        futures = []
        for i, r in enumerate(reqs):
            due = start + r["due"]
            while (delay := due - time.monotonic()) > 0:
                time.sleep(min(delay, TICK_S))
                if on_window is not None:
                    on_window(time.monotonic() - start)
            futures.append(pool.submit(one, i, r, due))
        if on_window is not None:
            while (left := start + seconds - time.monotonic()) > 0:
                time.sleep(min(left, TICK_S))
                on_window(time.monotonic() - start)
            on_window(seconds)
        for f in futures:          # each send is bounded by its timeout
            f.result()
    return records, start


def measure(records: list, reqs: list, start: float, seconds: float
            ) -> dict:
    """End-to-end numbers of one window. The rate is the tokens (prompt
    plus generated) of every request due in the window that was answered,
    over the time from the window's start to the last answer: all of the
    window's work over all the time it took, so that falling behind shows,
    and not a count of the requests that happen to end before the close,
    which moves by a whole request at a time."""
    import stats
    close = start + seconds
    lat = [(r["done"] - r["due"]) * 1e3 if r and r["ok"] else math.inf
           for r in records]
    ok = [(q, r) for q, r in zip(reqs, records) if r and r["ok"]]
    tokens = sum(len(q["prompt"]) + q["max_new"] for q, _ in ok)
    last = max((r["done"] for _, r in ok), default=close)
    done_tokens = sum(len(q["prompt"]) + q["max_new"] for q, r in ok
                      if r["done"] <= close)
    return {"serve_latency_p90_ms": stats.percentile(lat, 90),
            "serve_tokens_per_s": stats.rate(tokens, last - start),
            "in_window_tokens_per_s": stats.rate(done_tokens, seconds),
            "last_answer_s": last - start,
            "latency_ms": {f"p{q}": stats.percentile(lat, q)
                           for q in (50, 75, 95)},
            "completed_in_window": sum(1 for r in records
                                       if r and r["ok"]
                                       and r["done"] <= close),
            "late_s": max((r["sent"] - r["due"]) for r in records if r)}


def sample(records: list, reqs: list, seed: int, k: int) -> list:
    """Indices of up to k finished requests: the one with the most served
    tokens and the one with the longest prompt, the rest drawn from the
    seed."""
    import numpy as np
    ok = [i for i, r in enumerate(records) if r and r["ok"]]
    if not ok:
        return []
    picked = {max(ok, key=lambda i: reqs[i]["max_new"]),
              max(ok, key=lambda i: len(reqs[i]["prompt"]))}
    rest = [i for i in ok if i not in picked]
    rng = np.random.default_rng(seed)
    n_more = max(0, min(k - len(picked), len(rest)))
    picked.update(int(i) for i in rng.choice(rest, n_more, replace=False))
    return sorted(picked)


def reference_logits(c, spec, reqs, records, idx, device,
                     precisions=("f32",)) -> dict:
    """{precision: logits per sampled request} of the reference's full
    forwards over prompt + served tokens, from the server's seeded
    weights worked out again."""
    import torch

    from reference import decoder, init_recipe
    decoder.pin_f32()
    dev = torch.device(device)
    params = init_recipe.params(spec, c.traffic["server_init_seed"], dev)
    seqs = [(torch.tensor(reqs[i]["prompt"] + records[i]["tokens"],
                          device=dev), len(reqs[i]["prompt"]))
            for i in idx]
    out = decoder.score_served(params, seqs, spec, precisions)
    del params
    return out


def run(c, seed: int, seconds: float, trace: bool, device: str, t0: float,
        fault: str = "", control: bool = False) -> dict:
    import manifest
    from reference import compare
    from reference.spec import from_dict

    spec = from_dict(c.config, c.config_name)
    tr = c.traffic
    gen = manifest.generator(c)
    reqs = gen.requests(tr, seed, seconds, spec.vocab)
    warm = gen.requests(tr, seed + 1, tr["warmup"]["requests"]
                        / tr["rate_per_s"], spec.vocab)
    server = Server(c, trace, device, fault)
    summary = None
    try:
        server.wait_ready()
        with ThreadPoolExecutor(max_workers=SENDERS) as pool:
            list(pool.map(lambda r: send(server.port, r["prompt"],
                                         r["max_new"], START_TIMEOUT_S),
                          warm))
        setup_s = time.perf_counter() - t0

        trace_from = max(0.0, seconds - TRACE_S)
        marks = {"start": False, "close": False}

        def on_window(offset):
            if not trace:
                return
            if not marks["start"] and offset >= trace_from:
                server.signal(signal.SIGUSR1)
                marks["start"] = True
            if not marks["close"] and offset >= seconds:
                server.signal(signal.SIGUSR2)
                marks["close"] = True
        records, start = offer(server.port, reqs, seconds, on_window)
        e2e = measure(records, reqs, start, seconds)
        if trace:
            server.signal(signal.SIGUSR2)
            summary = server.read("trace.json")
            waits = [r["queue_wait_ms"] for r in records
                     if r and r["ok"] and r["queue_wait_ms"] is not None]
            summary.update(kind="serve", queue_waits_ms=waits,
                           completed_in_window=e2e["completed_in_window"],
                           run_window_s=seconds)
        server_stats = server.stop()
    finally:
        server.close()
    gc.collect()

    if "forbidden" not in server_stats:
        raise RuntimeError("the server wrote no stats at its exit")
    failed = sum(1 for r in records if not (r and r["ok"]))
    idx = sample(records, reqs, seed, tr["check_requests"])
    tick = time.perf_counter()
    logits = reference_logits(c, spec, reqs, records, idx, device,
                              ("f32", "fp8") if control else ("f32",))
    ref_s = time.perf_counter() - tick
    if control:
        # the float8 forward in the program's place: at each position of
        # the same prompts and served tokens, the token it puts first
        served = [lg.argmax(dim=-1).tolist() for lg in logits["fp8"]]
    else:
        served = [records[i]["tokens"] for i in idx]
    numbers = {"served_gap": compare.served_gap(logits["f32"], served)
               if idx else math.inf,
               "worst": {"sampled": len(idx),
                         "served_tokens": sum(map(len, served))}}
    out_e2e = {"setup_s": setup_s}
    if not trace:
        out_e2e.update(serve_latency_p90_ms=e2e["serve_latency_p90_ms"],
                       serve_tokens_per_s=e2e["serve_tokens_per_s"])
    return {"attempted": len(reqs), "failed": failed, "e2e": out_e2e,
            "summary": summary, "numbers": numbers,
            "timing": {"setup_s": setup_s, "reference_s": ref_s,
                       "late_s": e2e["late_s"],
                       "completed_in_window": e2e["completed_in_window"],
                       "in_window_tokens_per_s":
                           e2e["in_window_tokens_per_s"],
                       "last_answer_s": e2e["last_answer_s"],
                       "latency_ms": e2e["latency_ms"]},
            "memory_peak_bytes": int(server_stats["memory_peak_bytes"]),
            "forbidden": server_stats["forbidden"]}

"""Schedulable inference server, PyTorch port: the single-host,
single-flight path of gpu_docker_api_tpu/workloads/serve.py.

The control plane schedules this exactly like the training workload
(`POST /replicaSet {"cmd": [... serve, ...]}`, the granted port passed via
--port or $PORT): it loads a model (a fresh seeded init, or the newest
checkpoint of a torch `train_llama` workdir) and answers token-level
generation requests over HTTP, byte-compatible with the JAX server:

  GET  /healthz               -> {"code":200, "data":{"model","params",
                                  "vocab","maxSeqLen"}}
  POST /generate              body {"tokens": [[...]], "max_new": N,
                                    "temperature": 0.0, "top_k": 0,
                                    "top_p": 1.0}
                              -> {"code":200, "data":{"tokens": [[...]]}}

Every response is HTTP 200 with the control plane's {code, msg, data}
envelope. Serving is single-flight: one request at a time runs
infer.generate (or infer.speculative_generate for one row when a draft is
loaded) on the card. --device cpu serves from the CPU instead (tests).

Not yet ported, and refused at start-up: the continuous batcher
(--batch-slots and every flag that configures it), paged KV and the /kv
handoff, --host-load, tensor parallelism, multi-host serving and the MoE
family.

Run: python -m gpu_docker_api_tpu_torch.workloads.serve --config tiny \
        --device cpu --port 8000
"""

from __future__ import annotations

import argparse
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def _load_params(trainer, ckpt_dir: str | None, init_seed: int = 0) -> dict:
    """Served weights: a fresh Trainer.init(init_seed), or the newest
    checkpoint under `ckpt_dir` (a train_llama workdir's checkpoints/),
    detached from autograd once (the trainer's leaves require grad)."""
    from ..train import restore_checkpoint, tree_map
    if not ckpt_dir:
        params = trainer.init(init_seed)["params"]
    else:
        # scheduled workloads pass volume-bind paths relative to
        # $CONTAINER_ROOT (the process substrate's cwd)
        state, step = restore_checkpoint(os.path.abspath(ckpt_dir),
                                         trainer.abstract_state(),
                                         device=trainer.device)
        print(f"restored checkpoint step {step}", flush=True)
        params = state["params"]
    return tree_map(lambda t: t.detach(), params)


def _n_params(params: dict) -> int:
    """Parameter count as the JAX server reports it: every array leaf, the
    int8 weights and their scales alike."""
    from ..ops.quant import QTensor
    from ..train import tree_leaves
    return sum(x.q.numel() + x.s.numel() if isinstance(x, QTensor)
               else x.numel() for x in tree_leaves(params))


class _Server:
    def __init__(self, config, params, kv_quant: bool = False,
                 draft: tuple = None, gamma: int = 4):
        self.config = config
        self.params = params
        self.kv_quant = kv_quant
        self.draft = draft             # (draft_config, draft_params) | None
        self.gamma = gamma
        self.device = params["embed"].device   # serve where the weights are
        self.lock = threading.Lock()   # single-flight: one card
        self.n_params = _n_params(params)

    def generate(self, tokens, max_new: int, temperature: float,
                 top_k: int = 0, top_p: float = 1.0):
        import torch

        from ..infer import generate, speculative_generate
        try:
            prompt = torch.tensor(tokens, dtype=torch.long)
        except (OverflowError, RuntimeError) as e:   # ints past int64
            raise ValueError(f"token id out of range ({e})") from e
        if prompt.ndim != 2 or prompt.numel() == 0:
            raise ValueError("tokens must be [batch, prompt_len]")
        if int(prompt.max()) >= self.config.vocab_size or int(prompt.min()) < 0:
            raise ValueError("token id out of range")
        with self.lock:
            prompt = prompt.to(self.device)
            gen = torch.Generator(device=self.device).manual_seed(
                int.from_bytes(os.urandom(4), "big"))
            # speculative path: one sequence + a draft loaded. Greedy is
            # exactly the target-only greedy stream; sampling is exact via
            # rejection sampling
            if self.draft is not None and prompt.shape[0] == 1:
                dcfg, dparams = self.draft
                out, _ = speculative_generate(
                    self.params, dparams, prompt, self.config, dcfg,
                    int(max_new), gamma=self.gamma, kv_quant=self.kv_quant,
                    temperature=float(temperature), top_k=int(top_k),
                    top_p=float(top_p), generator=gen)
            else:
                out = generate(self.params, prompt, self.config, int(max_new),
                               temperature=float(temperature),
                               top_k=int(top_k), top_p=float(top_p),
                               kv_quant=self.kv_quant, generator=gen)
            return out.cpu().tolist()


def _handler_for(srv: _Server, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # keep-alive envelope responses flush headers and body as two
        # segments; a fronting gateway pays Nagle + delayed-ACK per
        # request without this
        disable_nagle_algorithm = True

        def log_message(self, *a):
            pass

        def _send(self, code: int, msg: str, data):
            payload = json.dumps(
                {"code": code, "msg": msg, "data": data}).encode()
            self.send_response(200)     # control-plane envelope style
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            # W3C trace continuity: echo the caller's traceparent
            tp = self.headers.get("traceparent")
            if tp:
                self.send_header("traceparent", tp)
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, "Success", {
                    "model": model_name,
                    "params": srv.n_params,
                    "vocab": srv.config.vocab_size,
                    "maxSeqLen": srv.config.max_seq_len,
                })
            elif self.path.startswith("/kv?") or self.path == "/kv":
                # the KV handoff exports come from the paged batcher, which
                # this server does not run
                self._send(404, "kv export not found", None)
            else:
                self._send(404, "route not found", None)

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, "route not found", None)
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(length) or b"{}")
                tokens = body["tokens"]
                max_new = int(body.get("max_new", 16))
                temperature = float(body.get("temperature", 0.0))
                top_k = int(body.get("top_k", 0))
                top_p = float(body.get("top_p", 1.0))
                if max_new < 1:
                    raise ValueError("max_new must be >= 1")
                if not 0.0 < top_p <= 1.0:
                    raise ValueError("top_p must be in (0, 1]")
                if top_k < 0:
                    raise ValueError("top_k must be >= 0")
                if not 0.0 <= temperature <= 10.0:
                    raise ValueError("temperature must be in [0, 10]")
                # the JAX server's buckets for the sampling parameters
                # without a batcher (there they bound its compiled
                # programs): 201 temperatures x 20 top_p x 129 top_k
                temperature = round(temperature * 20) / 20
                top_p = round(top_p * 20) / 20 or 0.05
                top_k = min(top_k, 128)
                out = srv.generate(tokens, max_new, temperature,
                                   top_k=top_k, top_p=top_p)
                self._send(200, "Success", {"tokens": out})
            except (KeyError, TypeError, ValueError) as e:
                self._send(400, f"bad request: {e}", None)

    return Handler


def _refuse_unported(args, env=None) -> None:
    """SystemExit for what the port cannot serve yet; where the JAX server
    itself refuses a combination, its message."""
    e = os.environ if env is None else env
    hosts = [h for h in e.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    if len(hosts) > 1:
        raise SystemExit(f"a {len(hosts)}-worker grant: multi-host serving "
                         f"is not yet ported to PyTorch")
    if args.family == "moe":
        raise SystemExit("--family moe: the MoE family is not yet ported to "
                         "PyTorch")
    if args.shard_kv:
        raise SystemExit(
            "--shard-kv is multihost serving (the single-host cache "
            "has no mesh to shard over)")
    if args.host_load:
        if not args.quantize:
            raise SystemExit("--host-load exists to serve models whose "
                             "bf16 weights exceed HBM; it requires "
                             "--quantize w8|w8a8")
        raise SystemExit("--host-load (streamed int8 quantization) is not "
                         "yet ported to PyTorch")
    if not args.batch_slots:
        if args.prefix_cache:
            raise SystemExit("--prefix-cache lives in the batching "
                             "scheduler; it needs --batch-slots N")
        if args.kv_block or args.kv_pool:
            raise SystemExit("--kv-block/--kv-pool configure the batching "
                             "scheduler's cache; they need --batch-slots N")
    batcher = [f"--{name.replace('_', '-')}" for name, default in (
        ("batch_slots", 0), ("batch_max_len", 0), ("batch_prefill_chunk", 0),
        ("prefix_cache", 0), ("kv_block", 0), ("kv_pool", 0),
        ("decode_chunk", 1), ("admit_queue", 0))
        if getattr(args, name) != default]
    if batcher:
        raise SystemExit(f"{' '.join(batcher)}: the continuous batcher is "
                         f"not yet ported to PyTorch")
    if args.tp > 1:
        raise SystemExit(f"--tp {args.tp}: tensor-parallel serving is not "
                         f"yet ported to PyTorch")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="llama", choices=["llama", "moe"])
    p.add_argument("--config", default="tiny",
                   help="named config for the family (models.NAMED_CONFIGS; "
                        "e.g. tiny, mini, 250m, 1b, llama3_8b)")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint dir (the training workload's "
                        "<workdir>/checkpoints); fresh init when empty")
    p.add_argument("--quantize", default="", choices=["", "w8", "w8a8"],
                   help="int8 post-load quantization of the matmul weights "
                        "(ops/quant.py): w8 = weight-only, w8a8 = +dynamic "
                        "activation int8")
    p.add_argument("--host-load", action="store_true",
                   help="load on the host and stream int8 to the card (not "
                        "yet ported; requires --quantize)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8 KV cache: half the cache bytes a decode step "
                        "reads (per-token-per-head scales, dequantized in "
                        "the attend)")
    p.add_argument("--draft-config", default="",
                   help="named config of a draft model for speculative "
                        "decoding of B=1 requests (greedy stream exact; "
                        "sampling exact via rejection sampling)")
    p.add_argument("--draft-checkpoint", default="",
                   help="checkpoint for the draft (fresh init when empty — "
                        "useful only for testing)")
    p.add_argument("--gamma", type=int, default=4,
                   help="speculative proposal length per round")
    p.add_argument("--batch-slots", type=int, default=0,
                   help="continuous batching (not yet ported)")
    p.add_argument("--batch-max-len", type=int, default=0,
                   help="slot cache length (continuous batching)")
    p.add_argument("--batch-prefill-chunk", type=int, default=0,
                   help="chunked prefill (continuous batching)")
    p.add_argument("--prefix-cache", type=int, default=0,
                   help="prefix KV reuse (continuous batching)")
    p.add_argument("--kv-block", type=int, default=0,
                   help="paged slot cache block size (continuous batching)")
    p.add_argument("--kv-pool", type=int, default=0,
                   help="paged pool size in blocks (continuous batching)")
    p.add_argument("--decode-chunk", type=int, default=1,
                   help="decode steps per host sync (continuous batching)")
    p.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel width (not yet ported above 1)")
    p.add_argument("--shard-kv", action="store_true",
                   help="shard the slot cache over tp (multi-host serving)")
    p.add_argument("--admit-queue", type=int, default=0,
                   help="replica-side admission bound of the batcher's "
                        "queue (continuous batching)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0,
                   help="0 = the control plane's granted port ($PORT from "
                        "the process substrate), falling back to 8000")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to serve: the CUDA card (default; raises "
                        "without one) or, when asked, the CPU")
    args = p.parse_args(argv)
    if not args.port:
        args.port = int(os.environ.get("PORT", "8000"))
    _refuse_unported(args)

    from ..device import resolve_device
    device = resolve_device(args.device)   # no card and no --device cpu: raise
    from ..models import named_config
    from ..train import Trainer

    try:
        config = named_config(args.family, args.config)
    except KeyError as e:
        p.error(str(e))

    params = _load_params(Trainer.create(config, device=device),
                          args.checkpoint)
    if args.quantize:
        from ..ops.quant import quantize_params
        params = quantize_params(params, args.quantize)
        print(f"quantized matmul weights to int8 ({args.quantize})",
              flush=True)
    draft = None
    if args.draft_config:
        try:
            dcfg = named_config(args.family, args.draft_config)
        except KeyError as e:
            p.error(str(e))
        # fresh-init drafts use seed 1: under the target's seed 0 a
        # same-named-config draft would BE the target
        dparams = _load_params(Trainer.create(dcfg, device=device),
                               args.draft_checkpoint, init_seed=1)
        if dcfg.vocab_size != config.vocab_size:
            raise SystemExit("draft and target must share a vocab")
        draft = (dcfg, dparams)
        print(f"speculative decoding armed: draft {args.draft_config}, "
              f"gamma {args.gamma}", flush=True)
    srv = _Server(config, params, kv_quant=args.kv_quant, draft=draft,
                  gamma=args.gamma)

    name = f"{args.family}/{args.config}"
    httpd = ThreadingHTTPServer((args.host, args.port),
                                _handler_for(srv, name))
    print(f"serving {name} ({srv.n_params:,} params) on "
          f"{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

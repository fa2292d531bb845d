"""One run of one cell: set-up, the measured window, the reference's check,
and the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name BENCHMARK.json
gives it: `configs/<file>` (sizes, curve, scheme, circuit, setup seed),
`traffic/<mix>.json` (read by `witness_stream` and the window loop),
`circuits/<circuit>.py` (the circuit on the port's constraint system),
`reference/circuits/<circuit>.py` (its R1CS for the reference) and
`metrics/<metric>.py` (a reader of the traced run's record).

The window: after set-up, `workers` closed loops (one prover process each)
start proves back to back until `--seconds` have passed; the window ends
when the last prove begun before then has finished, so no prove is cut.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE_DIR = os.path.join(BENCH_DIR, "cache")  # git-ignored
FORBIDDEN = ("jax", "jaxlib", "flax", "marlin_tpu")
SCHEMES = ("Marlin", "MarlinSonic")


def process_seconds() -> float:
    """Seconds since this process started (Linux: /proc/self/stat field 22)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    """The cell's entry with its config (file read) and traffic resolved,
    and the per-layer metrics it reports."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = read_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = read_json(os.path.join(BENCH_DIR, "traffic", f"{wl['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"workload": wl, "config": config, "traffic": traffic, "end_to_end": e2e, "per_layer": layer}


def sources_digest() -> str:
    """Digest of the program's sources: an archive made by other sources is never read."""
    h = hashlib.sha256()
    tops = [os.path.join(ROOT, "marlin_tpu_torch"), os.path.join(ROOT, "csrc")]
    for top in tops:
        for d, dirs, files in sorted(os.walk(top)):
            dirs[:] = sorted(x for x in dirs if x not in ("build", "__pycache__"))
            for f in sorted(files):
                if f.endswith((".py", ".cu", ".cuh", ".c", ".h")):
                    p = os.path.join(d, f)
                    h.update(os.path.relpath(p, ROOT).encode())
                    with open(p, "rb") as fh:
                        h.update(fh.read())
    return h.hexdigest()[:16]


def cache_path(config: dict, cache_dir: str | None = None) -> str:
    """The key archive of a configuration, named by the configuration and
    the digest of the program's sources."""
    key = hashlib.sha256(json.dumps(config, sort_keys=True).encode()).hexdigest()[:16]
    return os.path.join(cache_dir or CACHE_DIR, f"{config['name']}-{key}-{sources_digest()}", "keys.npz")


def make_keys(config: dict, device: str, path: str) -> None:
    """The configuration's universal setup (from its fixed setup seed) and
    index, archived at `path` as one prover key with its SRS.  A prover
    keeps what proving reads, the G1 and gamma powers and the index: Sonic's
    negative G2 powers serve only the verifier key, which the index keys
    already hold, and are dropped."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.snark import marlin, serial
    from marlin_tpu_torch.utils.rand import ZkRng

    cls = getattr(marlin, config["scheme"])
    circuits = load_file(os.path.join(BENCH_DIR, "circuits", f"{config['circuit']}.py"),
                         f"_bench_circuit_{config['circuit']}")
    n, v, m = config["universal_setup"]
    srs = cls.universal_setup(n, v, m, ZkRng(config["setup_seed"]), device=device)
    circuit = circuits.Circuit(P.R_MODULUS, 1, 2, config["num_constraints"], config["num_variables"])
    pk, _ = cls.index(srs, circuit, device=device)
    pk.committer_key.pp.neg_powers_of_h = None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    serial.save_index_pk(pk, path, include_srs=True)


def prepare_environment(config: dict) -> None:
    """Set what the port reads from the environment before it is imported:
    only the configuration's own settings, and the caches inside the checkout."""
    for k in [k for k in os.environ if k.startswith("MARLIN_TPU_")]:
        del os.environ[k]
    os.environ["MARLIN_TPU_CURVE"] = config["curve"]
    os.environ.update({k: str(v) for k, v in config.get("env", {}).items()})
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE_DIR, "nv")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def seed_stream(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use of the run's seed (any whole number)."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([seed % (1 << 64), stream])))


def witness_stream(seed: int, stream: int, r: int, bits: int):
    """Endless (a, b, zk_seed): two uniform field elements and a seed for
    the prove's blinding randomness.  Stream 0 feeds the window, stream 1
    the warm-up, so the window's witnesses do not depend on the warm-up."""
    gen = seed_stream(seed, stream)
    mask = (1 << bits) - 1

    def fr() -> int:
        while True:
            v = int.from_bytes(gen.bytes(32), "little") & mask
            if v < r:
                return v

    while True:
        a, b = fr(), fr()
        yield a, b, int(gen.integers(0, 1 << 63))


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """One run of a cell in this process: `setup()`, then `window()`, then `judge()`."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda"):
        self.spec = spec
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.setup_parts: dict = {}
        self.proves: list = []  # (start, end, proof | None, witness)
        self.synthesis: list = []
        self.record: dict | None = None
        self.clock = time.perf_counter

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        import torch

        from marlin_tpu_torch.fields import active as P
        from marlin_tpu_torch.snark import marlin, serial
        from marlin_tpu_torch.utils.rand import ZkRng

        cfg = self.config
        if cfg["scheme"] not in SCHEMES:
            raise ValueError(f"unknown scheme {cfg['scheme']!r}")
        if P.CURVE_NAME != cfg["curve"]:
            raise RuntimeError(f"the port runs {P.CURVE_NAME}, the configuration states {cfg['curve']}")
        self.torch = torch
        self.P = P
        self.ZkRng = ZkRng
        self.cls = getattr(marlin, cfg["scheme"])
        circuits = load_file(os.path.join(BENCH_DIR, "circuits", f"{cfg['circuit']}.py"),
                             f"_bench_circuit_{cfg['circuit']}")
        self.Circuit = circuits.Circuit
        self.setup_parts["imports_s"] = process_seconds()
        path = cache_path(cfg)
        if not os.path.exists(path):
            t = time.perf_counter()
            if self.device == "cuda":
                # in a process of its own, which ends before this one touches
                # the card: the window of a first run then runs in the same
                # process state as every later run's
                subprocess.run([sys.executable, os.path.join(BENCH_DIR, "keygen.py"), json.dumps(cfg), path],
                               check=True)
            else:
                make_keys(cfg, self.device, path)
            self.setup_parts["keygen_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if self.device == "cuda":
            from marlin_tpu_torch.ops import cuda

            cuda.lib()
        self.setup_parts["build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.pk = serial.load_index_pk(path, device=self.device)
        self.setup_parts["key_load_s"] = time.perf_counter() - t

        t = time.perf_counter()
        warm = witness_stream(self.seed, 1, P.R_MODULUS, P.FR_BITS)
        for _ in range(int(self.traffic["warmup_proves"])):
            a, b, zk = next(warm)
            self.cls.prove(self.pk, self._circuit(a, b, []), ZkRng(zk), device=self.device)
        self._sync()
        self.setup_parts["warmup_s"] = time.perf_counter() - t

    def _circuit(self, a: int, b: int, timings: list):
        cfg = self.config
        return self.Circuit(self.P.R_MODULUS, a, b, cfg["num_constraints"], cfg["num_variables"], timings)

    def _sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    # -- the window -------------------------------------------------------------
    def window(self) -> None:
        if self.traffic["arrivals"] != "closed" or int(self.traffic["workers"]) != 1:
            raise ValueError("this harness drives one closed-loop prover a process")
        from marlin_tpu_torch.ops import cuda
        from marlin_tpu_torch.snark import kzg

        stream = witness_stream(self.seed, 0, self.P.R_MODULUS, self.P.FR_BITS)
        launches0 = sum(cuda.LAUNCHES.values())
        reruns0 = kzg.STATS["exact_reruns"]
        gc_pauses: list = []

        def on_gc(phase, info):
            gc_pauses.append(time.perf_counter())

        gc.callbacks.append(on_gc)
        tracer = None
        if self.trace:
            from .trace import Tracer

            tracer = Tracer(self.torch, self.cls.PC, self.device)
            tracer.__enter__()
        try:
            start = self.clock()
            while self.clock() - start < self.seconds:
                a, b, zk = next(stream)
                t = self.clock()
                try:
                    proof = self.cls.prove(self.pk, self._circuit(a, b, self.synthesis), self.ZkRng(zk),
                                           device=self.device)
                    self._sync()
                except Exception:  # a failed prove is counted, and the loop goes on
                    traceback.print_exc(file=sys.stderr)
                    proof = None
                self.proves.append((t, self.clock(), proof, (a, b)))
            end = self.proves[-1][1]
        finally:
            gc.callbacks.remove(on_gc)
            if tracer is not None:
                tracer.__exit__(None, None, None)
        self.window_s = end - start
        self.diagnostics = {
            "prove_s": [e - s for s, e, _, _ in self.proves],
            "synthesis_s": [e - s for s, e in self.synthesis],
            "gc_pause_s": sum(b - a for a, b in zip(gc_pauses[0::2], gc_pauses[1::2])),
        }
        self.counters = {"launches": sum(cuda.LAUNCHES.values()) - launches0,
                         "exact_reruns": kzg.STATS["exact_reruns"] - reruns0}
        if tracer is not None:
            self.record = tracer.record((start, end), list(self.synthesis))

    # -- after the window ---------------------------------------------------------
    def release(self) -> dict:
        """Read the card's peak, keep what the reference judges (the proofs'
        bytes, the index commitments), and free the program's state."""
        dev = {}
        if self.device == "cuda":
            torch = self.torch
            dev = {"kind": torch.cuda.get_device_name(0),
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
        self.outputs = [(w, None if p is None else p.to_bytes()) for _, _, p, w in self.proves]
        self.index_comms = [c.comm for c in self.pk.index_vk.index_comms]
        self.proves = [(s, e, None, w) for s, e, _, w in self.proves]
        del self.pk
        if self.device == "cuda":
            self.torch.cuda.empty_cache()
        return dev

    def judge(self) -> tuple:
        """-> (numbers compared, each {'value', 'limit'}; failed proves)."""
        from .reference.judge import Judge

        ref = Judge(self.config, self.config["setup_seed"])
        failed = 0
        for witness, proof in self.outputs:
            reasons = ["no proof"] if proof is None else ref.proof_failures(witness, proof)
            if reasons:
                failed += 1
                print(f"proof of {witness} rejected: {'; '.join(reasons)}", file=sys.stderr)
        compared = {
            "proofs_rejected": {"value": failed, "limit": 0},
            "index_comms_differing": {"value": ref.index_comms_differing(self.index_comms), "limit": 0},
        }
        return compared, failed

    # -- metrics --------------------------------------------------------------------
    def end_to_end(self, setup_s: float) -> dict:
        n = len(self.proves)
        values = {
            "setup_s": setup_s,
            "constraints_per_s": n * self.config["num_constraints"] / self.window_s,
        }
        out = {}
        for m in self.spec["end_to_end"]:
            if m["name"] not in values:
                raise KeyError(f"no measurement of {m['name']}")
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out

    def per_layer(self, memory_peak_bytes: int) -> dict:
        rec = dict(self.record)
        rec.update({"num_proves": len(self.proves), "counters": self.counters,
                    "setup": self.setup_parts, "memory_peak_bytes": memory_peak_bytes})
        out = {}
        for m in self.spec["per_layer"]:
            reader = load_file(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py"),
                               f"_bench_metric_{m['name']}")
            value = reader.read(rec)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def decide(compared: dict, failed: int, attempted: int) -> bool:
    """`correct`: every prove of the window returned a proof the reference
    accepts, and every number compared is within its limit."""
    return attempted > 0 and failed == 0 and all(c["value"] <= c["limit"] for c in compared.values())


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"

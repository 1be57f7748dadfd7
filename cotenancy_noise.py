#!/usr/bin/env python3
"""Phase 17(a) of ``chip_smoke.py`` (``launch.mixed.main`` at full width
under the thermal trace) at a chosen upgrade patience, with the serve job's
step times as measured ("clean") or with emulated noise ("noisy": x1.4 on a
quarter of the serve ticks, drawn from seed 0, and x1.1 on every serve tick
while the train job is off its lean rung, as a co-tenant that slows serving
would). Prints, for each run, whether the serve job came back up from
serve-lean, and both jobs' migrations. Without a card it runs the reduced
model on the CPU.

    python3 cotenancy_noise.py 1:clean 1:noisy 5:noisy
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.engine import jobs, runtime  # noqa: E402
from repro_torch.kernels import backend  # noqa: E402
from repro_torch.launch import mixed  # noqa: E402

STATE = {"mode": "clean", "jobs": None, "rng": None}


def install_noise() -> None:
    """Keep the runtime's jobs in reach and scale the serve job's measured
    step time as the mode says (the monitor reads ``latency_s``)."""
    runtime_init, serve_step = runtime.SwanRuntime.__init__, jobs.ServeJob.step

    def init(self, job_list, *args, **kw):
        STATE["jobs"] = list(job_list)
        runtime_init(self, job_list, *args, **kw)

    def step(self, tick):
        report = serve_step(self, tick)
        if STATE["mode"] == "noisy":
            train = next(j for j in STATE["jobs"] if j.name == "train")
            factor = 1.4 if STATE["rng"].random() < 0.25 else 1.0
            if train.active_rung.name != "lean":
                factor *= 1.1
            report.latency_s *= factor
        return report

    runtime.SwanRuntime.__init__, jobs.ServeJob.step = init, step


def argv_for(patience: str, cuda: bool) -> list:
    if cuda:
        c = chip_smoke.COTENANT
        return chip_smoke.mixed_argv(
            ticks=c["ticks"], requests=c["requests"], prompt_len=c["prompt_len"],
            gen=c["gen"], thermal_trace=c["thermal"], upgrade_patience=patience)
    return ["--device", "cpu", "--reduced", "--ticks", "48", "--batch", "2", "--seq",
            "32", "--slots", "8", "--requests", "8", "--gen", "60",
            "--upgrade-patience", patience]


def main(specs) -> int:
    cuda = torch.cuda.is_available()
    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        backend.build_libraries(["flash_fwd", "flash_bwd", "flash_decode_paged",
                                 "flash_decode_spec"])
    install_noise()
    for spec in specs:  # patience:mode
        patience, mode = spec.split(":")
        STATE["mode"], STATE["rng"] = mode, np.random.default_rng(0)
        res = mixed.main(argv_for(patience, cuda) + ["--quiet"])
        moves = {n: [(m.step, m.from_rung, m.to_rung) for m in res.timeline.migrations
                     if m.job == n] for n in ("serve", "train")}
        up = any(m[1] == "serve-lean" for m in moves["serve"])
        print(f"== patience {patience} {mode}: serve "
              f"{'came back up' if up else 'did NOT come back up'}; "
              f"serve {moves['serve']}; train {moves['train']}", flush=True)
        del res
        STATE["jobs"] = None
        chip_smoke.free_cuda()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["1:clean", "1:noisy", "5:noisy"]))

"""Campaign orchestration: parameter-file generation with content-hashed
names (the reference's tests/json/generate.py + generate_parameters.sh) and
job-script emission (job_generator.py) retargeted from SLURM/MPI to
single-host invocations of the drivers."""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path


def content_hashed_name(params: dict, prefix: str = "cfg") -> str:
    blob = json.dumps(params, sort_keys=True).encode()
    return f"{prefix}_{hashlib.sha1(blob).hexdigest()[:12]}.json"


def generate_parameter_file(base: dict, overrides: dict, out_dir: str,
                            prefix: str = "cfg") -> str:
    """Merge overrides into base config and write under a content-hashed
    name (reference tests/json/generate.py:7-11)."""
    merged = dict(base)
    merged.update(overrides)
    name = content_hashed_name(merged, prefix)
    path = Path(out_dir) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(merged, indent=4))
    return str(path)


def generate_convergence_campaign(out_dir: str, problem: str = "heat",
                                  types=("DG", "CGP"),
                                  distort_coeffs=(0.0, 0.5),
                                  steps_at_once=(1, 2, 4)) -> list[str]:
    """The reference's convergence campaign matrix
    (generate_parameters.sh:5-36)."""
    base = {
        "doOutput": "false", "spaceTimeMg": "true",
        "problemType": problem, "feDegree": "1", "nDegCycles": "3",
        "nRefCycles": "4", "refinement": "2", "usePMg": "true",
        "coarseningType": "space_and_time",
    }
    files = []
    for t in types:
        for d in distort_coeffs:
            for n in steps_at_once:
                files.append(generate_parameter_file(
                    base, {"timeType": t, "distortCoeff": str(d),
                           "nTimestepsAtOnce": str(n)}, out_dir,
                    prefix=f"{problem}_{t}"))
    return files


def emit_job_script(config_path: str, out_dir: str, dim: int = 3,
                    driver: str = "stfem_tpu.drivers.tp01") -> str:
    """Single-host runner script (the reference's job_generator.py emits
    SLURM/srun scripts; here one host runs the jitted sharded solver)."""
    name = Path(config_path).stem
    script = Path(out_dir) / f"run_{name}.sh"
    script.parent.mkdir(parents=True, exist_ok=True)
    script.write_text(
        "#!/bin/bash\nset -e\n"
        f"python -m {driver} --file {config_path} --dim {dim} "
        f"| tee {out_dir}/{name}.log\n")
    os.chmod(script, 0o755)
    return str(script)


def extract_tables(log_text: str) -> dict[str, list[str]]:
    """Pull the convergence and iteration-count tables out of a driver log
    (the reference's postprocess awk, submit_job_postprocess.sh:33-35:
    print from 'Convergence table' / 'Iteration count table' headers to the
    next blank line).  Returns {header: [table lines incl. header]}."""
    out: dict[str, list[str]] = {}
    lines = log_text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith(("Convergence table", "Iteration count table")):
            block = [line]
            i += 1
            while i < len(lines) and lines[i].strip():
                block.append(lines[i])
                i += 1
            out.setdefault(line.strip(), []).extend(block)
        else:
            i += 1
    return out


def postprocess_campaign(out_dir: str, dest_dir: str | None = None) -> dict:
    """Collect tables from every run log in out_dir into per-table text
    files (the reference's submit_job_postprocess.sh output/<name>/ layout).
    Returns {log name: extracted tables}."""
    out_dir = Path(out_dir)
    dest = Path(dest_dir) if dest_dir else out_dir / "output"
    results = {}
    for log in sorted(out_dir.glob("*.log")):
        tables = extract_tables(log.read_text())
        results[log.stem] = tables
        tdir = dest / log.stem
        tdir.mkdir(parents=True, exist_ok=True)
        for header, block in tables.items():
            fname = ("convergence.txt" if header.startswith("Convergence")
                     else "iterations.txt")
            (tdir / fname).write_text("\n".join(block) + "\n")
    return results

"""Cluster job layer: scheduler-agnostic job specs + backend renderers (port
of diner_tpu.cluster.jobs, for GPU nodes).

Behavioral reference: the HTCondor submit files in
deps/TransMVSNet/condor_scripts/*.sub (single multi-accelerator training
jobs: request_cpus/request_memory/request_gpus/requirements + log plumbing)
and deps/facescape_preprocessing/process_dataset.sub (array jobs:
`queue SubjectID from <file>` with `concurrency_limits`) in
malteprinzler/diner.

Instead of hard-coding one scheduler, a job is described once as a
`JobSpec` and rendered to the backend in use:

- ``to_condor``   — an HTCondor .sub file (the reference's own fields; the
  text is the JAX package's, `gpu:<n>[:<name>]` becoming request_gpus and
  a CUDADeviceName requirement).
- ``to_jobset``   — a Kubernetes JobSet manifest for GPU nodes: an
  `nvidia.com/gpu` limit of the spec's cards per pod, a node selector on
  the NVIDIA GPU feature-discovery product label (in place of the JAX
  package's GKE TPU selectors), the torch.distributed env that
  parallel/multihost.py reads for multi-host jobs (in place of JAX's
  coordinator env), and completion-indexed array jobs.
- ``run_local``   — executes an array job in-process with a concurrency
  cap and bounded per-item retries (the reference's condor eviction/retry
  semantics, scaled down): used by tests and for single-machine runs.

Canonical specs mirroring the reference's submit files live in
`diner_tpu_torch.cluster.specs`; `python -m diner_tpu_torch.cli.submit`
renders or runs them.
"""

from __future__ import annotations

import dataclasses
import shlex
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One schedulable unit of work.

    `command` is an argv list; the placeholder ``{item}`` in any element is
    substituted per array item (reference: `$(SubjectID)` in
    process_dataset.sub). `array_file` names a text file with one item per
    line; None means a single (non-array) job.
    """

    name: str
    command: Sequence[str]
    cpus: int = 1
    memory_mb: int = 4000
    disk_gb: int = 10
    # accelerator request per host: "gpu:<count>[:<device name>]" (the
    # cards of one node; condor's request_gpus/requirements, the JobSet's
    # nvidia.com/gpu limit and product selector), or "" for CPU only
    accelerator: str = ""
    num_hosts: int = 1
    array_file: str | None = None
    concurrency: int | None = None
    max_retries: int = 2
    log_dir: str = "logs"
    env: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def item_command(self, item: str) -> list[str]:
        return [c.replace("{item}", item) for c in self.command]


def to_condor(spec: JobSpec) -> str:
    """Render an HTCondor submit file (reference submit-file contract:
    condor_scripts/transmvsnet_train_dtu.sub:1-12, process_dataset.sub)."""
    argv = list(spec.command)
    lines = [
        f"executable = {argv[0]}",
        'arguments = "' + " ".join(
            a.replace("{item}", "$(Item)") for a in argv[1:]) + '"',
        f"request_cpus = {spec.cpus}",
        f"request_memory = {spec.memory_mb}",
        f"request_disk = {spec.disk_gb}G",
    ]
    if spec.accelerator.startswith("gpu:"):
        parts = spec.accelerator.split(":")
        lines.append(f"request_gpus = {parts[1]}")
        if len(parts) > 2:
            lines.append(f'requirements = TARGET.CUDADeviceName=="{parts[2]}"')
    elif spec.accelerator:
        lines.append(f'requirements = TARGET.AcceleratorType=="{spec.accelerator}"')
    if spec.env:
        # ONE environment command: condor submit commands are last-one-wins,
        # so per-var lines would silently drop all but the final variable
        pairs = " ".join(f"{k}={v}" for k, v in spec.env.items())
        lines.append(f'environment = "{pairs}"')
    tag = "$(ClusterId).$(Process)" + ("_$(Item)" if spec.array_file else "")
    lines += [
        f"log_root = {spec.log_dir}/{spec.name}_{tag}",
        "error = $(log_root).err",
        "output = $(log_root).out",
        "log = $(log_root).log",
    ]
    if spec.concurrency:
        lines.append(f"concurrency_limits = user.{spec.name}:{spec.concurrency}")
    if spec.array_file:
        lines.append(f"queue Item from {spec.array_file}")
    else:
        lines.append("queue")
    return "\n".join(lines) + "\n"


def gpu_request(accelerator: str):
    """"gpu:<count>[:<device name>]" -> (count, name or None); (0, None)
    for a CPU-only spec."""
    if not accelerator:
        return 0, None
    parts = accelerator.split(":", 2)
    if parts[0] != "gpu" or len(parts) < 2:
        raise ValueError(f"accelerator {accelerator!r}: expected "
                         "gpu:<count>[:<device name>] or ''")
    return int(parts[1]), (parts[2] if len(parts) > 2 else None)


def to_jobset(spec: JobSpec, image: str = "diner-tpu-torch:latest",
              port: int = 29500) -> dict:
    """Render a Kubernetes JobSet manifest (as a dict; dump with yaml) for
    GPU nodes — the counterpart of the reference's condor layer.

    Each pod asks for the spec's cards (`nvidia.com/gpu`) on a node whose
    NVIDIA feature-discovery label `nvidia.com/gpu.product` names the card
    (its device name with dashes for spaces). Multi-host jobs get
    `spec.num_hosts` indexed completions with MASTER_ADDR/MASTER_PORT
    pointing at completion 0's pod DNS name (JobSet pods are named
    <jobset>-<replicatedJob>-<jobIndex>-<podIndex> on the jobset-named
    headless service), WORLD_SIZE the pod count and RANK the pod's
    completion index: what parallel/multihost.py reads for one rank a pod;
    a command that starts torchrun passes them on as its --nnodes,
    --node-rank and master address (Kubernetes expands `$(NAME)` in a
    command), and torchrun gives each card's process its own. Array jobs
    become indexed completions over the items file: each pod resolves its
    own item by line number (JOB_COMPLETION_INDEX) from the items file,
    which must be available inside the image/volume at the recorded path.
    """
    n_gpus, gpu_name = gpu_request(spec.accelerator)
    node_selector = {}
    if gpu_name:
        node_selector["nvidia.com/gpu.product"] = gpu_name.replace(" ", "-")
    env = [{"name": k, "value": str(v)} for k, v in spec.env.items()]
    if spec.num_hosts > 1:
        env += [
            {"name": "MASTER_ADDR",
             "value": f"{spec.name}-work-0-0.{spec.name}"},
            {"name": "MASTER_PORT", "value": str(port)},
            {"name": "WORLD_SIZE", "value": str(spec.num_hosts)},
            {"name": "RANK",
             "valueFrom": {"fieldRef": {"fieldPath":
                 "metadata.annotations['batch.kubernetes.io/job-completion-index']"}}},
        ]

    if spec.array_file:
        n_items = None
        try:
            n_items = len([ln for ln in
                           Path(spec.array_file).read_text().splitlines()
                           if ln.strip()])
        except OSError:
            raise ValueError(
                f"array_file {spec.array_file!r} must be readable at render "
                "time so the JobSet completion count matches the items")
        completions = n_items
        # each indexed pod picks its line from the items file; {item} may be
        # embedded in a longer path ("...RAW/{item}") so substitute in place
        def word(c: str) -> str:
            if "{item}" not in c:
                return shlex.quote(c)
            return '"' + (c.replace("\\", "\\\\").replace('"', '\\"')
                          .replace("{item}", "${ITEM}")) + '"'

        item_cmd = " ".join(word(c) for c in spec.command)
        command = ["/bin/sh", "-c",
                   f'ITEM=$(sed -n "$((JOB_COMPLETION_INDEX+1))p" '
                   f'{shlex.quote(spec.array_file)}) && exec {item_cmd}']
    else:
        completions = spec.num_hosts
        command = list(spec.command)

    container = {
        "name": spec.name,
        "image": image,
        "command": command,
        "env": env,
        "resources": {"limits": {
            "cpu": str(spec.cpus),
            "memory": f"{spec.memory_mb}Mi",
            **({"nvidia.com/gpu": str(n_gpus)} if n_gpus else {}),
        }},
    }
    job_template = {
        "spec": {
            "completions": completions,
            "parallelism": (min(spec.concurrency, completions)
                            if spec.concurrency else completions),
            "completionMode": "Indexed",
            "backoffLimit": spec.max_retries,
            "template": {
                "spec": {
                    "nodeSelector": node_selector,
                    "restartPolicy": "Never",
                    "subdomain": spec.name,
                    "containers": [container],
                },
            },
        },
    }
    return {
        "apiVersion": "jobset.x-k8s.io/v1alpha2",
        "kind": "JobSet",
        "metadata": {
            "name": spec.name,
            **({"annotations": {"diner-tpu/array-items-file":
                                spec.array_file}}
               if spec.array_file else {}),
        },
        "spec": {
            "replicatedJobs": [{"name": "work", "replicas": 1,
                                "template": job_template}],
        },
    }


def run_local(spec: JobSpec, items: Sequence[str] | None = None,
              log_dir: str | Path | None = None,
              runner=subprocess.run) -> dict:
    """Execute the job (or its array items) locally with the spec's
    concurrency cap and bounded retries. Returns {item: returncode}.

    The reference gets retries from condor's evict/requeue machinery;
    here each item is retried up to `max_retries` times on nonzero exit.
    """
    log_dir = Path(log_dir or spec.log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    if items is None:
        if spec.array_file:
            items = [ln.strip() for ln in
                     Path(spec.array_file).read_text().splitlines()
                     if ln.strip()]
        else:
            items = [""]

    def run_one(item: str) -> int:
        argv = spec.item_command(item)
        tag = item or "job"
        log = log_dir / f"{spec.name}_{tag}.log"
        for attempt in range(spec.max_retries + 1):
            with open(log, "a") as fh:
                fh.write(f"+ attempt {attempt}: {shlex.join(argv)}\n")
                fh.flush()
                proc = runner(argv, stdout=fh, stderr=subprocess.STDOUT)
            rc = proc.returncode
            if rc == 0:
                return 0
        return rc

    # duplicate array lines would race on the same log file and collapse
    # into one result key — run each distinct item once, like condor's
    # queue-from dedups identical procs by args
    items = list(dict.fromkeys(items))
    workers = spec.concurrency or len(items) or 1
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        results = dict(zip(items, pool.map(run_one, items)))
    return results

"""Canonical job specs — the reference's submit files, one per entry, on
the port's CLIs (port of diner_tpu.cluster.specs; the same seven names).

Behavioral reference (malteprinzler/diner):
  deps/TransMVSNet/condor_scripts/transmvsnet_train_dtu.sub        (8 GPUs)
  deps/TransMVSNet/condor_scripts/transmvsnet_train_facescape.sub
  deps/TransMVSNet/condor_scripts/transmvsnet_train_multiface.sub
  deps/TransMVSNet/condor_scripts/transmvsnet_write_facescape.sub
  deps/TransMVSNet/condor_scripts/transmvsnet_write_multiface.sub
  deps/facescape_preprocessing/process_dataset.sub                 (array job)

What follows the reference: cpus, memory and disk (workload statements),
the array job's items file and its concurrency of 10, and the 8 cards of
the TransMVSNet training jobs (the reference's 8x RTX 2080 Ti).

What is the port's: the card is an H100 (`gpu:<n>:NVIDIA H100 80GB HBM3`);
a spec asking for several cards on one host starts one rank a card with
`python -m torch.distributed.run --nproc-per-node <n>` and the CLI's
`--multihost`; `mvs write` is one process on one card; the FaceScape
preprocessing asks for one card, since its depth rasterizer runs there
(the reference's is CPU-only); multi-host DINER training is 4 hosts of 8
cards, torchrun taking the pod count, the pod's rank and rank 0's address
from the JobSet's env (cluster/jobs.py:to_jobset), so that spec is for the
JobSet backend (condor would read its `$(NAME)`s as its own macros). Paths
are parameterized by {data}/{out} and resolved by the submit CLI.
"""

from __future__ import annotations

from diner_tpu_torch.cluster.jobs import JobSpec

PY = "python"
H100 = "NVIDIA H100 80GB HBM3"
CARDS = 8


def torchrun(n: int, *module_argv: str, hosts: bool = False):
    """argv starting one rank a card of the host with torchrun; with
    `hosts`, across the JobSet's pods (Kubernetes expands `$(NAME)` from
    the pod's env)."""
    across = ["--nnodes", "$(WORLD_SIZE)", "--node-rank", "$(RANK)",
              "--master-addr", "$(MASTER_ADDR)",
              "--master-port", "$(MASTER_PORT)"] if hosts else []
    return [PY, "-m", "torch.distributed.run", "--nproc-per-node", str(n),
            *across, "-m", *module_argv]


def _mvs_train(name: str, dataset, datapath: str, logdir: str) -> JobSpec:
    return JobSpec(
        name=name,
        command=torchrun(CARDS, "diner_tpu_torch.cli.mvs", "train",
                         *(["--dataset", dataset] if dataset else []),
                         "--datapath", datapath,
                         "--listfile",
                         "lists/dtu/train.txt" if not dataset else "unused",
                         "--logdir", logdir, "--multihost"),
        cpus=16, memory_mb=80000, disk_gb=100,
        accelerator=f"gpu:{CARDS}:{H100}",
    )


def _mvs_write(name: str, dataset: str, datapath: str, ckpt: str) -> JobSpec:
    return JobSpec(
        name=name,
        command=[PY, "-m", "diner_tpu_torch.cli.mvs", "write",
                 "--dataset", dataset, "--datapath", datapath,
                 "--listfile", "unused", "--ckpt", ckpt],
        cpus=7, memory_mb=70000, disk_gb=100,
        accelerator=f"gpu:1:{H100}",
    )


SPECS = {
    "mvs-train-dtu": _mvs_train("mvs-train-dtu", None,
                                "{data}/dtu_training", "{out}/mvs_dtu"),
    "mvs-train-facescape": _mvs_train(
        "mvs-train-facescape", "facescape", "{data}/FACESCAPE_PROCESSED",
        "{out}/mvs_facescape"),
    "mvs-train-multiface": _mvs_train(
        "mvs-train-multiface", "multiface", "{data}/MULTIFACE_PROCESSED",
        "{out}/mvs_multiface"),
    "mvs-write-facescape": _mvs_write(
        "mvs-write-facescape", "facescape", "{data}/FACESCAPE_PROCESSED",
        "{out}/mvs_facescape/ckpts"),
    "mvs-write-multiface": _mvs_write(
        "mvs-write-multiface", "multiface", "{data}/MULTIFACE_PROCESSED",
        "{out}/mvs_multiface/ckpts"),
    # array job: one FaceScape subject per item, 10 at a time
    # (process_dataset.sub: request_cpus=1, 34 GB, concurrency 10,
    # `queue SubjectID from incomplete_subjects.txt`), each on one card
    "facescape-preprocess": JobSpec(
        name="facescape-preprocess",
        command=[PY, "-m", "diner_tpu_torch.preprocess.facescape_pipeline",
                 "--dir-in", "{data}/FACESCAPE_RAW/{item}",
                 "--dir-out", "{data}/FACESCAPE_PROCESSED/{item}"],
        cpus=1, memory_mb=34000, disk_gb=300,
        accelerator=f"gpu:1:{H100}",
        array_file="assets/data_splits/facescape/subjects.txt",
        concurrency=10,
    ),
    # multi-host DINER training: 4 hosts of 8 cards, one rank a card
    "diner-train-dtu-multihost": JobSpec(
        name="diner-train-dtu-multihost",
        command=torchrun(CARDS, "diner_tpu_torch.cli.train",
                         "configs/train_dtu.yaml", "--logdir",
                         "{out}/diner_dtu", "--multihost", hosts=True),
        cpus=16, memory_mb=80000, disk_gb=100,
        accelerator=f"gpu:{CARDS}:{H100}",
        num_hosts=4,
    ),
}

"""The training cell, which ``BENCHMARK.json`` does not hold yet (PERF.md,
Open questions: its control does not come out as not correct), for the tests
of the harness's training path."""

from portbench import spec

TRAIN_CONFIG = {"name": "fs-vitl-train-v1", "source": "https://arxiv.org/abs/2501.09898",
                "file": "portbench/configs/fs-vitl-train-v1.json", "reduced": [],
                "why": "the training recipe configs/train/stereo_v1.json as shipped"}
TRAIN_CELL = {"name": "train-vitl-b2", "config": "fs-vitl-train-v1",
              "traffic": "train-320x736-b2", "chips": 1,
              "why": "train steps of batch 2 on [320, 736] (W, H) crops"}
TRAIN_METRICS = [{"name": "train_samples_per_s", "unit": "samples/s", "better": "higher",
                  "bound": 0.25, "source": "host_clock", "workloads": ["train-vitl-b2"]}]


def bench_with_train() -> dict:
    bench = spec.benchmark()
    bench["configs"].append(TRAIN_CONFIG)
    bench["workloads"].append(TRAIN_CELL)
    bench["end_to_end"] = TRAIN_METRICS + bench["end_to_end"]
    return bench


def cell(name: str) -> dict:
    return spec.cell(name, bench_with_train())

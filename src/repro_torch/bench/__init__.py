"""Benchmark support: the schema-versioned JSON artifact writer shared by
every bench script (serving_bench, vision_bench, ...)."""
from repro_torch.bench.artifacts import (SCHEMA_VERSION, git_sha,
                                         load_bench_artifact,
                                         write_bench_artifact)

__all__ = ["SCHEMA_VERSION", "write_bench_artifact", "load_bench_artifact",
           "git_sha"]

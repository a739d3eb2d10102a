"""The small sizes the CPU tests run the cells at: 4,096 rows, short
requests, few warm-up steps.  Widths stay the configurations' own."""

SMALL = {"cfg": {"samples": 4096, "reference_block_rows": 1024},
         "mix": {"warmup_steps": 1, "strata": 8, "sample_requests": 4,
                 "min_seconds": 0.01, "max_seconds": 0.05}}

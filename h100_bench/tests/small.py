"""Sizes at which the benchmark's cells run on the CPU in the tests: the
configurations' widths and the mixes' shapes cut so that a cell takes
seconds there. The comparisons are the cells' own."""
SMALL = {
    "hippo-train-f32": {
        "config": {"crop_shape": [16, 16, 8], "filters": 4},
        "traffic": {"raw_grid": [20, 18, 6], "warmup_iterations": 3, "trace_from": 5,
                    "trace_iterations": 4, "num_workers": 0}},
    "hippo-tta-bf16": {
        "config": {"crop_shape": [16, 16, 8], "filters": 4},
        "traffic": {"pool": 4, "trace_requests": 2, "kept": 2}},
    "msseg2-serve-f32": {
        "config": {"filters": [4, 4, 8]},
        "traffic": {"grid": [40, 36, 34], "semi_axes": [15, 14, 12], "patch": 32,
                    "overlap": 16, "trace_requests": 1, "kept": 2}},
}


def small_driver(workload, seed, workdir, device="cpu"):
    """The cell's driver at the small size, set up and run for a second."""
    import torch

    from h100_bench import harness

    spec = harness.load_spec()
    cell = harness.find(spec["workloads"], workload, "workload")
    config = {**harness.load_config(cell["config"]), **SMALL[workload]["config"]}
    traffic = {**harness.load_traffic(cell["traffic"]), **SMALL[workload]["traffic"]}
    driver = harness.load_driver(traffic["driver"]).Driver(config, traffic, seed,
                                                            torch.device(device), workdir)
    driver.setup()
    driver.run(1.0, None, lambda: None)
    driver.release()
    return driver

"""Suite config."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight tests (per-arch model compiles, real training "
        "runs, model-sized multi-device subprocesses); the fast tier-1 "
        "subset runs -m 'not slow' (see ROADMAP.md). Lightweight subprocess "
        "checks (e.g. the gossip HLO collective count) stay in the fast tier "
        "so CI always asserts them.",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the PyTorch port's hand-written kernels); "
        "skips without one, decided inside the test's fixture",
    )

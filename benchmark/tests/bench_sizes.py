"""Small sizes of every cell for the CPU tests, in float64 (the program's
own float64 route, so that a sound run sits far inside every limit and
only a fault can fail one)."""

SMALL = {
    "svgp32-train": ({"num_data": 256, "num_dims": 4, "num_inducing": 32}, {}),
    "sgpr8-fit4": ({"num_data": 2600, "train_rows": 2100, "num_dims": 3, "num_inducing": 40,
                    "max_interaction_depth": 3, "max_iters": 3, "warm_adam_steps": 2}, {}),
}


def small(cell: str, dtype: str = "float64"):
    """(configuration overrides, parameter overrides); in float64 the port's
    jitter is 1e-6, which the reference then takes too."""
    config, params = SMALL[cell]
    config = dict(config, dtype=dtype)
    if dtype == "float64":
        config["jitter"] = 1e-6
    return config, dict(params)

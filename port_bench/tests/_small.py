"""The tiny sizes the CPU rehearsals run at (m = 32)."""

SMALL = {"config": {"n_low": 20, "n_high": 8},
         "traffic": {"warmup_steps": 3, "pareto_grid": 100}}
SEED = 2**31 + 12345

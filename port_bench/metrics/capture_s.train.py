"""capture_s.train: the seconds the training phase's one-time set-up of its
replays took, its eager warm-up steps and its CUDA-graph capture, each
ending in a synchronize (a cost the BO loop pays once for every phase it
builds). Read from the program's counter mobocmf_tpu_torch/fit/graphs.py::
setup_seconds, the process's sum over its Steps: a cell's process builds
one phase, so one Steps. Silent where the program does not keep it."""


def read(ctx):
    if ctx.kind != "train":
        return None
    from mobocmf_tpu_torch.fit import graphs
    return getattr(graphs, "setup_seconds", None)

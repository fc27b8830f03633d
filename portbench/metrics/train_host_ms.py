"""Mean host ms a job spends in train() and save() outside the engine's
device-loop calls: each job's train()+save() span less the host spans
of the wrapped calls inside it.  In the traced run each wrapper below
is wrapped by name and synchronises at its call's end, so a call's span
holds its device work.  A name the port no longer has makes the metric
read nothing."""

import time

WRAPPERS = ("giant_train_step", "flat_train", "giant_sharded_train",
            "hist_fused_train")
MODULE = "shredword_tpu_torch.ops._kernels"


def prepare(run):
    import importlib

    import torch

    kernels = importlib.import_module(MODULE)
    if not all(hasattr(kernels, n) for n in WRAPPERS):
        run.state["train_host_ms"] = "missing"
        return
    depth = [0]

    class Wrapped:
        """The wrapper in the function's place.  The port's wrappers
        count launches through their own module-level name, so
        ``.launches`` reads and writes the wrapped function's counter."""

        def __init__(self, fn):
            self.fn = fn
            # launch_counts() keys a counter by the module that defines it
            self.__module__ = fn.__module__

        @property
        def launches(self):
            return self.fn.launches

        @launches.setter
        def launches(self, n):
            self.fn.launches = n

        def __call__(self, *args, **kw):
            if depth[0]:
                return self.fn(*args, **kw)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                with run.span("call"):
                    out = self.fn(*args, **kw)
                    if run.device.startswith("cuda"):
                        torch.cuda.synchronize()
            finally:
                depth[0] -= 1
                run.call_s += time.perf_counter() - t0
                run.calls += 1
            return out

    originals = {n: getattr(kernels, n) for n in WRAPPERS}
    for n, fn in originals.items():
        setattr(kernels, n, Wrapped(fn))

    def undo():
        for n, fn in originals.items():
            setattr(kernels, n, fn)

    run.on_close.append(undo)


def read(run):
    if run.state.get("train_host_ms") == "missing" or not run.jobs \
            or not run.calls:
        return None
    spent = sum(j.trained - j.loaded for j in run.jobs)
    return 1e3 * (spent - run.call_s) / len(run.jobs)

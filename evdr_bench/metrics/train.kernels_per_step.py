"""train.kernels_per_step: kernels launched in the traced window over the
training steps it holds (the profiler's kernel count)."""


def read(obs):
    t = obs.get("trace")
    if t is None or not obs.get("steps"):
        return None
    return t.kernels / obs["steps"]

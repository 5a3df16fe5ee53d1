"""The same rate for a mix that saves frames, each frame in host memory
before its simulation counts as done."""


def read(run):
    return run.particle_steps_per_s() if run.saves else None

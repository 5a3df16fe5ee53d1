"""n * nsteps * (whole simulations that did not fail) / window seconds,
for a mix that saves no frames after its checked simulation."""


def read(run):
    return None if run.saves else run.particle_steps_per_s()

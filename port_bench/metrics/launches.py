"""Device kernels a unit of the cell's traffic launches (a training
step, a sweep's batch, a request): the kernels in the traced span over
its units."""


def read(view):
    return len(view.kernels) / view.units if view.units else None

"""The mean host time of one ``StreamService.step`` and the wait for the device
that ends it, over the window's steps, in ms."""


def read(run):
    if not run.steps:
        return None
    return 1e3 * sum(wall for wall, _, _ in run.steps) / len(run.steps)

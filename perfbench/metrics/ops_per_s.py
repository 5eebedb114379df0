"""Operations completed OK in the window, over the window (client's clock)."""


def read(run):
    return run.ok_ops() / run.seconds

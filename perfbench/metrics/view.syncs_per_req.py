"""Device views (kernels/device_view.py): blocking device-to-host result
fetches (``device_view.SYNCS``) a request of the window."""


def read(run):
    n = run.after.get("view_syncs", 0) - run.before.get("view_syncs", 0)
    return n / len(run.window) if n and run.window else None

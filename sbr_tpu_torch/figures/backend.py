"""Which plotting backend the figure layer draws with: matplotlib when it
is importable, else the built-in PDF writer (`figures.pdfplot`), which
implements the part of matplotlib's API the figure layer uses. Machines
that run the port on a GPU need not have matplotlib; the replication run
still writes every PDF there. `name` says which one is in use, and the
master prints it.
"""

from __future__ import annotations


def _matplotlib():
    try:
        import matplotlib
    except ImportError:
        return None
    return matplotlib


def name() -> str:
    mpl = _matplotlib()
    return f"matplotlib {mpl.__version__}" if mpl is not None else "built-in PDF writer"


def pyplot():
    """matplotlib.pyplot, or the built-in module with the same calls."""
    if _matplotlib() is not None:
        import matplotlib.pyplot as plt

        return plt
    from sbr_tpu_torch.figures import pdfplot

    return pdfplot


def pdf_pages(path):
    """A multi-page PDF document for the combined figure document."""
    if _matplotlib() is not None:
        from matplotlib.backends.backend_pdf import PdfPages

        return PdfPages(path)
    from sbr_tpu_torch.figures.pdfplot import PdfPages

    return PdfPages(path)


def use_headless() -> None:
    """The non-interactive Agg backend for the CLI (matplotlib only)."""
    mpl = _matplotlib()
    if mpl is not None:
        mpl.use("Agg")

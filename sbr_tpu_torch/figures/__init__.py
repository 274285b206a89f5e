"""Figure layer of the port: the port of ``sbr_tpu.figures``.

Matplotlib builders for the reference's 13 figures (`plotting`) and the
replication runner (``python -m sbr_tpu_torch.figures.master``), which
writes every figure PDF, the combined document and
``replication_figures.tex``.
"""

from sbr_tpu_torch.figures.plotting import (
    plot_aw_hetero,
    plot_comp_stat_withdrawals_and_collapse,
    plot_equilibrium,
    plot_hazard_rate_decomposition,
    plot_heatmap_aw,
    plot_learning_distribution,
    plot_value_function,
)

__all__ = [
    "plot_aw_hetero",
    "plot_comp_stat_withdrawals_and_collapse",
    "plot_equilibrium",
    "plot_hazard_rate_decomposition",
    "plot_heatmap_aw",
    "plot_learning_distribution",
    "plot_value_function",
]

"""The residual DGCNN segmentation network (``residual-dgcnn``): exact
float32 kNN graphs of every block, trained by Adam on events of one
length. A banded graph (``knn_window``), a graph built every few blocks
(``knn_every``), EdgeConv MLPs of several layers (``block_convs``), the
bf16 or tensor-core path or the plain ``dgcnn`` need a work count and a
reference of their own: another network package."""

from .reference import Reference
from .weights import make as make_weights
from .work import work

__all__ = ["MODELLED", "Reference", "config_kwargs", "make_weights", "work"]

# The keys of each section this network models; where only some values
# are modelled, those (None: any value).
MODELLED = {
    "model": {"name": ("residual-dgcnn",), "num_class": None, "k": None, "in_dim": None,
              "edge_filters": None, "residual": (True,), "head_feat_dim": None,
              "head_mlp": None, "bn_momentum": None},
    "port": {"precision": ("default",), "knn_precision": ("highest",), "remat": (False, True)},
    "reference": {"matmul": ("float32",)},
    "control": {"matmul": ("tf32",)},
}


def config_kwargs(model: dict) -> dict:
    """The program's `Config` fields for the ``model`` section."""
    return dict(model_name=model["name"], num_class=model["num_class"], kvalue=model["k"],
                edge_filters=tuple(model["edge_filters"]),
                head_feat_dim=model["head_feat_dim"], head_mlp=tuple(model["head_mlp"]),
                bn_momentum=model["bn_momentum"])

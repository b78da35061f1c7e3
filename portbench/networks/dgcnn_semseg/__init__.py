"""The paper's semantic-segmentation DGCNN (``dgcnn``, Wang et al.,
arXiv:1801.07829, Fig. 3, as released for S3DIS in
github.com/WangYueFt/dgcnn ``tensorflow/sem_seg/model.py``): EdgeConv
blocks whose per-edge MLPs have one depth a block (``block_convs``, e.g.
``[2, 2, 1]``), no residual shortcut, the residual network's head, exact
float32 kNN graphs of every block, trained by Adam on events of one
length.

It extends `portbench.networks.residual_dgcnn` (its reference, weights
and work count), which it loads by name as the harness does, and edits
none of it."""

from . import residual
from .reference import Reference
from .weights import make as make_weights
from .work import work

__all__ = ["MODELLED", "Reference", "config_kwargs", "make_weights", "work"]

# The keys of each section this network models; where only some values
# are modelled, those (None: any value).
MODELLED = {
    **residual.MODELLED,
    "model": {**residual.MODELLED["model"], "name": ("dgcnn",), "residual": (False,),
              "block_convs": None},
}


def config_kwargs(model: dict) -> dict:
    """The program's `Config` fields for the ``model`` section."""
    depths = model["block_convs"]
    return {**residual.config_kwargs(model),
            "block_convs": depths if isinstance(depths, int) else tuple(depths)}

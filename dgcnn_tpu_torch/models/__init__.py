from dgcnn_tpu_torch.models.dgcnn import Model, ModelSpec, make_model
from dgcnn_tpu_torch.models.registry import get_model, model_names, register_model

__all__ = [
    "Model",
    "ModelSpec",
    "make_model",
    "get_model",
    "model_names",
    "register_model",
]

"""Model layer of the port (port of ``event_based_optical_flow_tpu/models/``):
EV-FlowNet, its building blocks and voxel-grid featurizer, the unsupervised
CMax training step, checkpoints and the CLI's DNN entry, and the weights'
conversion from and to the JAX package's flax layout."""

from .basic_layers import ConvBlock, ResidualBlock, UpsampleConvAndPredict
from .convert import params_from_flax, params_to_flax
from .ev_flownet import EVFlowNet, events_to_voxel_grid
from .train import dnn_train_step, make_dnn_train_state, run_dnn_flow, unsupervised_cmax_loss

__all__ = [
    "EVFlowNet",
    "events_to_voxel_grid",
    "ConvBlock",
    "ResidualBlock",
    "UpsampleConvAndPredict",
    "dnn_train_step",
    "make_dnn_train_state",
    "params_from_flax",
    "params_to_flax",
    "unsupervised_cmax_loss",
    "run_dnn_flow",
]

"""The accepted network this one extends, `residual_dgcnn`, loaded by name
as the harness loads a configuration's network: its reference and
weights modules, its work count and what it models."""

from portbench import harness

net = harness.load_network("residual_dgcnn")
reference, weights = net.reference, net.weights
MODELLED, config_kwargs, work = net.MODELLED, net.config_kwargs, net.work

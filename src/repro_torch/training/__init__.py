"""repro_torch.training — the projected train step, MMCS and the SAE factory
(port of ``repro/training``)."""
from .mmcs import mmcs, mmcs_sym, mmcs_table  # noqa: F401
from .sae_factory import (  # noqa: F401
    SAEFactoryConfig, gsp_whole_network, harvest_activations,
    make_sae_train_step, run_factory, train_sae,
)
from .step import init_state, make_loss_fn, make_train_step, xent  # noqa: F401

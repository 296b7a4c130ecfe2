"""Point-cloud losses and metrics of the port (counterpart of
``cloud_transformers_tpu/losses``): Chamfer distance, the auction EMD and
the F-score."""

from cloud_transformers_tpu_torch.losses.chamfer import (  # noqa: F401
    chamfer_distance,
    loss_chamfer,
    loss_chamfer_2d,
    loss_chamfer_adj,
)
from cloud_transformers_tpu_torch.losses.emd import (  # noqa: F401
    emd_auction,
    emd_auction_with_rounds,
    loss_emd,
)
from cloud_transformers_tpu_torch.losses.fscore import (  # noqa: F401
    f_score,
    f_score_from_dists,
)

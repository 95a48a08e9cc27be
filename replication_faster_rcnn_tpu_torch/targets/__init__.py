"""Target assignment of the PyTorch port (the JAX package's ``targets/``)."""

from replication_faster_rcnn_tpu_torch.targets.anchor_targets import (  # noqa: F401
    anchor_targets,
    batched_anchor_targets,
)
from replication_faster_rcnn_tpu_torch.targets.proposal_targets import (  # noqa: F401
    batched_proposal_targets,
    proposal_targets,
)
from replication_faster_rcnn_tpu_torch.targets.sampling import (  # noqa: F401
    draw_uniform,
    pack_by_priority,
    random_subset_mask,
    topk_subset_mask,
)

"""Neural-network modules (on nn/module.py): layers, embeddings, MMDiT blocks, encoders."""

from reptext.nn.layers import (  # noqa: F401
    AdaLayerNormContinuous,
    AdaLayerNormZero,
    AdaLayerNormZeroSingle,
    FeedForward,
    RMSNorm,
)
from reptext.nn.embeddings import (  # noqa: F401
    CombinedTimestepTextEmbed,
    MLPEmbedder,
    timestep_embedding,
)
from reptext.nn.blocks import (  # noqa: F401
    JointTransformerBlock,
    SingleTransformerBlock,
)

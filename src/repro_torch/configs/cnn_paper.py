"""The paper's own training workloads (§5): ResNet34, MobileNetV2, ShuffleNetV2.

ResNet-34 on GoogleSpeech (35 classes, spectrogram treated as 1-channel 32x32
image per FedScale's preprocessing); MobileNetV2 / ShuffleNetV2 on OpenImage
(600 classes). MobileNet/ShuffleNet are the depthwise-convolution-heavy models
whose multi-core cache-thrashing motivates Swan's pruning (paper §3.1, O2).
"""
from repro_torch.configs.base import ModelConfig

RESNET34 = ModelConfig(
    name="resnet34",
    family="cnn",
    cnn_kind="resnet",
    cnn_stages=(3, 4, 6, 3),
    cnn_widths=(64, 128, 256, 512),
    n_classes=35,
    in_channels=1,
    image_size=32,
    source="arXiv:1512.03385 (paper §5: GoogleSpeech)",
)

MOBILENET_V2 = ModelConfig(
    name="mobilenet-v2",
    family="cnn",
    cnn_kind="mobilenet",
    cnn_stages=(1, 2, 3, 4, 3, 3, 1),
    cnn_widths=(16, 24, 32, 64, 96, 160, 320),
    n_classes=600,
    in_channels=3,
    image_size=32,
    source="arXiv:1801.04381 (paper §5: OpenImage)",
)

SHUFFLENET_V2 = ModelConfig(
    name="shufflenet-v2",
    family="cnn",
    cnn_kind="shufflenet",
    cnn_stages=(4, 8, 4),
    cnn_widths=(116, 232, 464),
    n_classes=600,
    in_channels=3,
    image_size=32,
    source="arXiv:1807.11164 (paper §5: OpenImage)",
)

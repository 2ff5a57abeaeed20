"""Vision model zoo (counterpart of ``paddle_tpu/vision/models.py``: LeNet,
the ResNets in NCHW or NHWC, VGG, MobileNetV1 and MobileNetV2).  Dygraph
Layers; ``bench.py``'s ResNet-50 step trains
``resnet50(data_format="NHWC")`` through
``dygraph.functional.functional_loss``.  The MobileNets' depthwise
convolutions are ``conv2d`` ops with ``groups`` equal to the channels, as
in the reference (on the card, PyTorch's own depthwise kernels at NCHW
bf16)."""
from __future__ import annotations

from ..nn import (Layer, Sequential, Linear, Conv2D, BatchNorm, MaxPool2D,
                  AdaptiveAvgPool2D, ReLU, Flatten)
from ..dygraph.layers import LayerList
from ..fluid import layers as L

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "VGG", "vgg16", "vgg19",
           "MobileNetV1", "MobileNetV2", "vgg11", "vgg13", "mobilenet_v1",
           "mobilenet_v2"]


class LeNet(Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0), ReLU(),
            MaxPool2D(2, 2))
        self.fc = Sequential(
            Flatten(),
            Linear(400, 120), Linear(120, 84), Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        return self.fc(x)


class ConvBNLayer(Layer):
    def __init__(self, cin, cout, ksize, stride=1, groups=1, act=None,
                 data_format="NCHW"):
        super().__init__()
        self.conv = Conv2D(cin, cout, ksize, stride=stride,
                           padding=(ksize - 1) // 2, groups=groups,
                           bias_attr=False, data_format=data_format)
        self.bn = BatchNorm(cout, act=act, data_layout=data_format)

    def forward(self, x):
        return self.bn(self.conv(x))


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, cin, cout, stride=1, shortcut=True,
                 data_format="NCHW"):
        super().__init__()
        fmt = data_format
        self.conv0 = ConvBNLayer(cin, cout, 1, act="relu", data_format=fmt)
        self.conv1 = ConvBNLayer(cout, cout, 3, stride=stride, act="relu",
                                 data_format=fmt)
        self.conv2 = ConvBNLayer(cout, cout * 4, 1, data_format=fmt)
        if not shortcut:
            self.short = ConvBNLayer(cin, cout * 4, 1, stride=stride,
                                     data_format=fmt)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv2(self.conv1(self.conv0(x)))
        short = x if self.shortcut else self.short(x)
        return L.nn.relu(short + y)


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, cin, cout, stride=1, shortcut=True,
                 data_format="NCHW"):
        super().__init__()
        fmt = data_format
        self.conv0 = ConvBNLayer(cin, cout, 3, stride=stride, act="relu",
                                 data_format=fmt)
        self.conv1 = ConvBNLayer(cout, cout, 3, data_format=fmt)
        if not shortcut:
            self.short = ConvBNLayer(cin, cout, 1, stride=stride,
                                     data_format=fmt)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.conv1(self.conv0(x))
        short = x if self.shortcut else self.short(x)
        return L.nn.relu(short + y)


class ResNet(Layer):
    cfg = {18: (BasicBlock, [2, 2, 2, 2]),
           34: (BasicBlock, [3, 4, 6, 3]),
           50: (BottleneckBlock, [3, 4, 6, 3]),
           101: (BottleneckBlock, [3, 4, 23, 3]),
           152: (BottleneckBlock, [3, 8, 36, 3])}

    def __init__(self, depth=50, num_classes=1000, with_pool=True,
                 data_format="NCHW"):
        super().__init__()
        block, layers_cfg = self.cfg[depth]
        fmt = data_format
        self.stem = ConvBNLayer(3, 64, 7, stride=2, act="relu",
                                data_format=fmt)
        self.pool1 = MaxPool2D(3, 2, 1, data_format=fmt)
        cin = 64
        blocks = []
        for i, n in enumerate(layers_cfg):
            cout = 64 * 2 ** i
            for j in range(n):
                stride = 2 if j == 0 and i > 0 else 1
                shortcut = not (j == 0)
                blocks.append(block(cin, cout, stride, shortcut,
                                    data_format=fmt))
                cin = cout * block.expansion
        self.blocks = LayerList(blocks)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1, data_format=fmt)
        self.out_dim = cin
        if num_classes > 0:
            self.flatten = Flatten()
            self.fc = Linear(cin, num_classes)
        self.num_classes = num_classes

    def forward(self, x):
        x = self.pool1(self.stem(x))
        for b in self.blocks:
            x = b(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.flatten(x))
        return x


def resnet18(pretrained=False, **kw):
    return ResNet(18, **kw)


def resnet34(pretrained=False, **kw):
    return ResNet(34, **kw)


def resnet50(pretrained=False, **kw):
    return ResNet(50, **kw)


def resnet101(pretrained=False, **kw):
    return ResNet(101, **kw)


def resnet152(pretrained=False, **kw):
    return ResNet(152, **kw)


class VGG(Layer):
    cfgs = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
            16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}

    def __init__(self, depth=16, num_classes=1000):
        super().__init__()
        groups = self.cfgs[depth]
        chans = [64, 128, 256, 512, 512]
        layers_ = []
        cin = 3
        for g, c in zip(groups, chans):
            for _ in range(g):
                layers_ += [Conv2D(cin, c, 3, padding=1), ReLU()]
                cin = c
            layers_.append(MaxPool2D(2, 2))
        self.features = Sequential(*layers_)
        self.classifier = Sequential(
            Flatten(), Linear(512 * 7 * 7, 4096), ReLU(),
            Linear(4096, 4096), ReLU(), Linear(4096, num_classes))

    def forward(self, x):
        return self.classifier(self.features(x))


def vgg16(pretrained=False, **kw):
    return VGG(16, **kw)


def vgg19(pretrained=False, **kw):
    return VGG(19, **kw)


class DepthwiseSeparable(Layer):
    def __init__(self, cin, cout1, cout2, stride, scale=1.0):
        super().__init__()
        self.dw = ConvBNLayer(int(cin * scale), int(cout1 * scale), 3,
                              stride=stride, groups=int(cin * scale),
                              act="relu")
        self.pw = ConvBNLayer(int(cout1 * scale), int(cout2 * scale), 1,
                              act="relu")

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000):
        super().__init__()
        self.stem = ConvBNLayer(3, int(32 * scale), 3, stride=2, act="relu")
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        self.blocks = LayerList([DepthwiseSeparable(a, a, b, s, scale)
                                 for a, b, s in cfg])
        self.pool = AdaptiveAvgPool2D(1)
        self.flatten = Flatten()
        self.fc = Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.flatten(self.pool(x)))


class InvertedResidual(Layer):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        hidden = cin * expand
        self.use_res = stride == 1 and cin == cout
        seq = []
        if expand != 1:
            seq.append(ConvBNLayer(cin, hidden, 1, act="relu6"))
        seq += [ConvBNLayer(hidden, hidden, 3, stride=stride, groups=hidden,
                            act="relu6"),
                ConvBNLayer(hidden, cout, 1)]
        self.conv = Sequential(*seq)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000):
        super().__init__()
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        self.stem = ConvBNLayer(3, int(32 * scale), 3, stride=2, act="relu6")
        cin = int(32 * scale)
        blocks = []
        for t, c, n, s in cfg:
            cout = int(c * scale)
            for i in range(n):
                blocks.append(InvertedResidual(cin, cout,
                                               s if i == 0 else 1, t))
                cin = cout
        self.blocks = LayerList(blocks)
        self.head = ConvBNLayer(cin, int(1280 * scale), 1, act="relu6")
        self.pool = AdaptiveAvgPool2D(1)
        self.flatten = Flatten()
        self.fc = Linear(int(1280 * scale), num_classes)

    def forward(self, x):
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        return self.fc(self.flatten(self.pool(self.head(x))))


def vgg11(pretrained=False, **kw):
    return VGG(11, **kw)


def vgg13(pretrained=False, **kw):
    return VGG(13, **kw)


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    return MobileNetV1(scale=scale, **kw)


def mobilenet_v2(pretrained=False, scale=1.0, **kw):
    return MobileNetV2(scale=scale, **kw)

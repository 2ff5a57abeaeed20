"""Vision model zoo (counterpart of ``paddle_tpu/vision/models.py``: LeNet
and the ResNets, in NCHW or NHWC).  Dygraph Layers; ``bench.py``'s
ResNet-50 step trains ``resnet50(data_format="NHWC")`` through
``dygraph.functional.functional_loss``."""
from __future__ import annotations

from ..nn import (Layer, Sequential, Linear, Conv2D, BatchNorm, MaxPool2D,
                  AdaptiveAvgPool2D, ReLU, Flatten)
from ..dygraph.layers import LayerList
from ..fluid import layers as L

__all__ = ["LeNet", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152"]


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

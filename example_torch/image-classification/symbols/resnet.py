"""Symbolic ResNet (the port's copy of
example/image-classification/symbols/resnet.py).

Builds the mx.sym graph the Module/fit path trains (the gluon model zoo has
the imperative twin).
"""
from __future__ import annotations

import mxnet_tpu_torch.symbol as sym


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True):
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True,
                                name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3")
        shortcut = data if dim_match else sym.Convolution(
            act1, num_filter=num_filter, kernel=(1, 1), stride=stride,
            no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, momentum=0.9, eps=2e-5,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, momentum=0.9, eps=2e-5,
                        name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2")
    shortcut = data if dim_match else sym.Convolution(
        act1, num_filter=num_filter, kernel=(1, 1), stride=stride, no_bias=True,
        name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True):
    data = sym.Variable("data")
    (nchannel, height, width) = image_shape
    body = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=0.9,
                         name="bn_data")
    if height <= 32:
        body = sym.Convolution(body, num_filter=filter_list[0], kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               name="conv0")
    else:
        body = sym.Convolution(body, num_filter=filter_list[0], kernel=(7, 7),
                               stride=(2, 2), pad=(3, 3), no_bias=True,
                               name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                             name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", name="pool0")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name=f"stage{i + 1}_unit1", bottle_neck=bottle_neck)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name=f"stage{i + 1}_unit{j + 2}",
                                 bottle_neck=bottle_neck)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7), pool_type="avg",
                        name="pool1")
    flat = sym.Flatten(pool1, name="flatten")
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


def get_symbol(num_classes, num_layers, image_shape, **kwargs):
    image_shape = tuple(int(x) for x in image_shape.split(",")) \
        if isinstance(image_shape, str) else tuple(image_shape)
    (nchannel, height, width) = image_shape
    if height <= 28:
        num_stages = 3
        per_unit = [(num_layers - 2) // 9] * 3
        filter_list = [16, 64, 128, 256]
        bottle_neck = True
        units = per_unit
    else:
        num_stages = 4
        spec = {18: ([2, 2, 2, 2], False), 34: ([3, 4, 6, 3], False),
                50: ([3, 4, 6, 3], True), 101: ([3, 4, 23, 3], True),
                152: ([3, 8, 36, 3], True)}
        if num_layers not in spec:
            raise ValueError(f"no spec for resnet-{num_layers}")
        units, bottle_neck = spec[num_layers]
        filter_list = [64, 256, 512, 1024, 2048] if bottle_neck else \
            [64, 64, 128, 256, 512]
    return resnet(units, num_stages, filter_list, num_classes, image_shape,
                  bottle_neck)

"""ResNet for ImageNet (counterpart of ``paddle_tpu/models/resnet.py``;
v1_api_demo/model_zoo/resnet/resnet.py parity: bottleneck ResNet-50/101/152
with batch-norm conv blocks).

One of the JAX system's two north-star workloads (bench.py bench_resnet50:
B = 256, 224 x 224, bf16 compute over float32 masters). Spatial sizes are
never hand-threaded: the layer graph's shape inference is the one source.
"""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layer, pooling

DEPTH_CONFIGS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def conv_bn(input, ch_out, filter_size, stride, padding, active=True,
            name=None):
    # the conv stays linear before the batch norm: img_conv's act defaults
    # to Relu
    c = layer.img_conv(input=input, filter_size=filter_size,
                       num_filters=ch_out, stride=stride, padding=padding,
                       act=act.Linear(), bias_attr=False, name=name)
    return layer.batch_norm(input=c, num_channels=ch_out,
                            act=act.Relu() if active else None,
                            name=name and f"{name}_bn")


def bottleneck(input, ch_in, ch_out, stride, name):
    """1x1 -> 3x3 -> 1x1 (x4) with a projection shortcut where the shape
    changes (reference resnet.py bottleneck)."""
    mid = conv_bn(input, ch_out, 1, stride, 0, True, f"{name}_branch2a")
    mid = conv_bn(mid, ch_out, 3, 1, 1, True, f"{name}_branch2b")
    mid = conv_bn(mid, ch_out * 4, 1, 1, 0, False, f"{name}_branch2c")
    if stride != 1 or ch_in != ch_out * 4:
        shortcut = conv_bn(input, ch_out * 4, 1, stride, 0, False,
                           f"{name}_branch1")
    else:
        shortcut = input
    return layer.addto(input=[mid, shortcut], act=act.Relu(),
                       bias_attr=False, name=f"{name}_sum")


def resnet_imagenet(input_image, num_channels=3, img_size=224, depth=50,
                    num_classes=1000):
    in_shape = input_image.out_info().shape
    if in_shape is not None and in_shape != (num_channels, img_size,
                                             img_size):
        raise ValueError(f"input layer shape {in_shape} != declared "
                         f"({num_channels}, {img_size}, {img_size})")
    cfg = DEPTH_CONFIGS[depth]
    # relu(maxpool(bn(conv))) == maxpool(relu(bn(conv))) for the monotone
    # relu; pooling first shrinks the relu's backward from 112^2 to 56^2
    # (the JAX package's order, kept)
    c1 = conv_bn(input_image, 64, 7, 2, 3, False, "res_conv1")      # /2
    p0 = layer.img_pool(input=c1, pool_size=3, stride=2, padding=1,
                        pool_type=pooling.Max(), ceil_mode=False,
                        name="res_pool1")                            # /4
    p1 = layer.addto(input=[p0], act=act.Relu(), bias_attr=False,
                     name="res_conv1_relu")
    cur, ch_in = p1, 64
    for stage, blocks in enumerate(cfg):
        ch_out = 64 * (2 ** stage)
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            cur = bottleneck(cur, ch_in, ch_out, stride,
                             f"res{stage + 2}_{b}")
            ch_in = ch_out * 4
    final = cur.out_info().shape[-1]
    pooled = layer.img_pool(input=cur, pool_size=final, stride=1,
                            pool_type=pooling.Avg(), name="res_avgpool")
    return layer.fc(input=pooled, size=num_classes, act=act.Linear(),
                    name="res_fc")


def resnet_cost(depth=50, img_size=224, num_classes=1000, batch_prefix=""):
    """The training graph: data layers and the softmax cross-entropy
    cost. Returns (image, label, logits, cost)."""
    from paddle_tpu_torch import data_type

    img = layer.data(name=f"{batch_prefix}image",
                     type=data_type.dense_vector(3 * img_size * img_size),
                     shape=(3, img_size, img_size))
    lab = layer.data(name=f"{batch_prefix}label",
                     type=data_type.integer_value(num_classes))
    out = resnet_imagenet(img, 3, img_size, depth, num_classes)
    cost = layer.classification_cost(input=out, label=lab,
                                     name="resnet_cost")
    return img, lab, out, cost

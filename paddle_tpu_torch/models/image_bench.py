"""The reference benchmark's image configs (counterpart of
``paddle_tpu/models/image_bench.py``; benchmark/paddle/image/
{alexnet,googlenet,smallnet_mnist_cifar}.py parity). ``vgg`` builds on
``trainer_config_helpers.img_conv_group``, which the port does not have
yet, and waits for it (ROADMAP, queue 1 item 9).
"""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import data_type, layer, pooling


def smallnet_mnist_cifar():
    """benchmark/paddle/image/smallnet_mnist_cifar.py: 3 conv + pool
    blocks (32, 32, 64 filters 5x5), fc 64, 10 classes; input 3x32x32."""
    img = layer.data(name="image", type=data_type.dense_vector(3 * 32 * 32))
    lab = layer.data(name="label", type=data_type.integer_value(10))
    c1 = layer.img_conv(input=img, filter_size=5, num_filters=32,
                        num_channels=3, padding=2, act=act.Relu(),
                        img_size=32)
    p1 = layer.img_pool(input=c1, pool_size=3, stride=2,
                        pool_type=pooling.Max())
    c2 = layer.img_conv(input=p1, filter_size=5, num_filters=32, padding=2,
                        act=act.Relu())
    p2 = layer.img_pool(input=c2, pool_size=3, stride=2,
                        pool_type=pooling.Avg())
    c3 = layer.img_conv(input=p2, filter_size=5, num_filters=64, padding=2,
                        act=act.Relu())
    p3 = layer.img_pool(input=c3, pool_size=3, stride=2,
                        pool_type=pooling.Avg())
    fc1 = layer.fc(input=p3, size=64, act=act.Relu())
    out = layer.fc(input=fc1, size=10, act=act.Linear(), name="output")
    cost = layer.classification_cost(input=out, label=lab, name="cost")
    return img, lab, out, cost


def alexnet(num_classes=1000, img_size=227):
    """benchmark/paddle/image/alexnet.py (3x227x227)."""
    img = layer.data(name="image",
                     type=data_type.dense_vector(3 * img_size * img_size))
    lab = layer.data(name="label", type=data_type.integer_value(num_classes))
    c1 = layer.img_conv(input=img, filter_size=11, num_filters=96,
                        num_channels=3, stride=4, act=act.Relu(),
                        img_size=img_size)
    n1 = layer.img_cmrnorm(input=c1, size=5)
    p1 = layer.img_pool(input=n1, pool_size=3, stride=2,
                        pool_type=pooling.Max())
    c2 = layer.img_conv(input=p1, filter_size=5, num_filters=256, padding=2,
                        groups=1, act=act.Relu())
    n2 = layer.img_cmrnorm(input=c2, size=5)
    p2 = layer.img_pool(input=n2, pool_size=3, stride=2,
                        pool_type=pooling.Max())
    c3 = layer.img_conv(input=p2, filter_size=3, num_filters=384, padding=1,
                        act=act.Relu())
    c4 = layer.img_conv(input=c3, filter_size=3, num_filters=384, padding=1,
                        act=act.Relu())
    c5 = layer.img_conv(input=c4, filter_size=3, num_filters=256, padding=1,
                        act=act.Relu())
    p5 = layer.img_pool(input=c5, pool_size=3, stride=2,
                        pool_type=pooling.Max())
    f6 = layer.fc(input=p5, size=4096, act=act.Relu())
    f7 = layer.fc(input=f6, size=4096, act=act.Relu())
    out = layer.fc(input=f7, size=num_classes, act=act.Linear(),
                   name="output")
    cost = layer.classification_cost(input=out, label=lab, name="cost")
    return img, lab, out, cost


def _inception(name, input, ch_in, f1, f3r, f3, f5r, f5, proj, img_size):
    cov1 = layer.img_conv(input=input, filter_size=1, num_filters=f1,
                          num_channels=ch_in, act=act.Relu(),
                          img_size=img_size, name=f"{name}_1x1")
    cov3r = layer.img_conv(input=input, filter_size=1, num_filters=f3r,
                           num_channels=ch_in, act=act.Relu(),
                           img_size=img_size, name=f"{name}_3x3r")
    cov3 = layer.img_conv(input=cov3r, filter_size=3, num_filters=f3,
                          padding=1, act=act.Relu(), name=f"{name}_3x3")
    cov5r = layer.img_conv(input=input, filter_size=1, num_filters=f5r,
                           num_channels=ch_in, act=act.Relu(),
                           img_size=img_size, name=f"{name}_5x5r")
    cov5 = layer.img_conv(input=cov5r, filter_size=5, num_filters=f5,
                          padding=2, act=act.Relu(), name=f"{name}_5x5")
    pool = layer.img_pool(input=input, pool_size=3, stride=1, padding=1,
                          num_channels=ch_in, img_size=img_size,
                          pool_type=pooling.Max(), name=f"{name}_pool")
    covprj = layer.img_conv(input=pool, filter_size=1, num_filters=proj,
                            num_channels=ch_in, act=act.Relu(),
                            img_size=img_size, name=f"{name}_proj")
    return layer.concat(input=[cov1, cov3, cov5, covprj], name=name)


def googlenet(num_classes=1000, img_size=224):
    """benchmark/paddle/image/googlenet.py (GoogLeNet v1, main branch)."""
    img = layer.data(name="image",
                     type=data_type.dense_vector(3 * img_size * img_size))
    lab = layer.data(name="label", type=data_type.integer_value(num_classes))
    c1 = layer.img_conv(input=img, filter_size=7, num_filters=64,
                        num_channels=3, stride=2, padding=3, act=act.Relu(),
                        img_size=img_size)                       # 112
    p1 = layer.img_pool(input=c1, pool_size=3, stride=2,
                        pool_type=pooling.Max())                 # 56
    c2r = layer.img_conv(input=p1, filter_size=1, num_filters=64,
                         act=act.Relu())
    c2 = layer.img_conv(input=c2r, filter_size=3, num_filters=192, padding=1,
                        act=act.Relu())
    p2 = layer.img_pool(input=c2, pool_size=3, stride=2,
                        pool_type=pooling.Max())                 # 28
    i3a = _inception("i3a", p2, 192, 64, 96, 128, 16, 32, 32, 28)
    i3b = _inception("i3b", i3a, 256, 128, 128, 192, 32, 96, 64, 28)
    p3 = layer.img_pool(input=i3b, pool_size=3, stride=2, num_channels=480,
                        img_size=28, pool_type=pooling.Max())    # 14
    i4a = _inception("i4a", p3, 480, 192, 96, 208, 16, 48, 64, 14)
    i4b = _inception("i4b", i4a, 512, 160, 112, 224, 24, 64, 64, 14)
    i4c = _inception("i4c", i4b, 512, 128, 128, 256, 24, 64, 64, 14)
    i4d = _inception("i4d", i4c, 512, 112, 144, 288, 32, 64, 64, 14)
    i4e = _inception("i4e", i4d, 528, 256, 160, 320, 32, 128, 128, 14)
    p4 = layer.img_pool(input=i4e, pool_size=3, stride=2, num_channels=832,
                        img_size=14, pool_type=pooling.Max())    # 7
    i5a = _inception("i5a", p4, 832, 256, 160, 320, 32, 128, 128, 7)
    i5b = _inception("i5b", i5a, 832, 384, 192, 384, 48, 128, 128, 7)
    p5 = layer.img_pool(input=i5b, pool_size=7, stride=7, num_channels=1024,
                        img_size=7, pool_type=pooling.Avg())
    drop = layer.dropout(p5, 0.4)
    out = layer.fc(input=drop, size=num_classes, act=act.Linear(),
                   name="output")
    cost = layer.classification_cost(input=out, label=lab, name="cost")
    return img, lab, out, cost

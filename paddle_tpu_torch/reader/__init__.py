"""Reader protocol + decorators (counterpart of ``paddle_tpu/reader``;
analog of python/paddle/v2/reader/): a reader creator is a callable
returning an iterator over samples; decorators compose them."""

from paddle_tpu_torch.reader.decorator import (
    map_readers, buffered, compose, chain, shuffle, firstn, xmap_readers,
    cache, mixed, checkpointable, CheckpointableReader,
)
from paddle_tpu_torch.reader import creator


def minibatch_batch(reader, batch_size, drop_last=False):
    """paddle.batch analog (python/paddle/v2/minibatch.py)."""

    def batch_reader():
        b = []
        for sample in reader():
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


batch = minibatch_batch

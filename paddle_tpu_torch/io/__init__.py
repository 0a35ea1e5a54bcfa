"""Datasets, samplers and the DataLoader (counterpart of paddle_tpu/io)."""
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .dataset import (BatchSampler, ChainDataset, ComposeDataset,  # noqa: F401
                      ConcatDataset, Dataset, DistributedBatchSampler,
                      IterableDataset, RandomSampler, Sampler,
                      SequenceSampler, Subset, TensorDataset,
                      WeightedRandomSampler, random_split)

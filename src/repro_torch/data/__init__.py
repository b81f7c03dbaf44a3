"""Datasets and partitions (numpy, bitwise-equal to ``repro.data``)."""
from repro_torch.data.partition import (  # noqa: F401
    dirichlet_partition, iid_partition, shards_partition, train_test_split)
from repro_torch.data.synthetic import (  # noqa: F401
    make_image_dataset, make_imu_dataset, make_lm_dataset)

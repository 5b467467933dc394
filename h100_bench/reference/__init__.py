"""Plain PyTorch references of the benchmark's configurations: the
networks, the loss, the device augmentation, the training set's
preprocessing and the predictors' tiling and votes. They import nothing
of the program under test."""

"""The plain reference: the SparseConvNet U-Net at voxel level in plain
PyTorch, float32 with TF32 off. It imports nothing of the program."""

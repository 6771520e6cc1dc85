from repro_torch.ckpt.io import (convert_unstacked, flatten_tree, restore,
                                 save, to_unstacked, unflatten_tree)

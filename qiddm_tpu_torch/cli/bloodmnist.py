"""BloodMNIST rebuttal driver (counterpart of
``qiddm_tpu/cli/bloodmnist.py``, reference src/bloodmnist.py):
``python -m qiddm_tpu_torch.cli.bloodmnist --device cuda``."""

from .rebuttal_common import make_main

parse_args, main = make_main(
    "QDDM on BloodMNIST", default_data="bloodmnist_28x28",
    default_img_size=28, labels=[0], save_prefix="results/for_blood/",
    n_classes=8)

if __name__ == "__main__":
    main()

"""PneumoniaMNIST rebuttal driver (counterpart of
``qiddm_tpu/cli/PneumoniaMNIST.py``, reference src/PneumoniaMNIST.py):
``python -m qiddm_tpu_torch.cli.PneumoniaMNIST --device cuda``."""

from .rebuttal_common import make_main

parse_args, main = make_main(
    "QDDM on PneumoniaMNIST", default_data="PneumoniaMNIST_28x28",
    default_img_size=28, labels=[0], save_prefix="results/for_pneumonia/",
    n_classes=2)

if __name__ == "__main__":
    main()

"""Fruit-360 rebuttal driver (counterpart of
``qiddm_tpu/cli/fruit_360.py``, reference src/fruit_360.py): 64x64 images,
so its Qdense has 12 wires; ``python -m qiddm_tpu_torch.cli.fruit_360
--device cuda``."""

from .rebuttal_common import make_main

parse_args, main = make_main(
    "QDDM on Fruit-360", default_data="fruit_64x64", default_img_size=64,
    labels=[0, 1, 2], save_prefix="results/for_fruit/", n_classes=10)

if __name__ == "__main__":
    main()

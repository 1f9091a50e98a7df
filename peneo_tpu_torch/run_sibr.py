"""Fine-tune / evaluate PEneo (LiLT, LayoutLMv3 or LayoutLMv2; a visual
backbone reads the dataset's own page images) on SIBR with the PyTorch
port: the flags of :mod:`peneo_tpu_torch.run_rfund` (``--language`` is
unused), over ``SIBRDataset`` (``{split}.txt`` + ``converted_label/``).

    python -m peneo_tpu_torch.run_sibr --data_dir /path/to/sibr \\
        --model_name_or_path /path/to/peneo-weights --output_dir out \\
        --do_train --do_eval
"""

from .run_rfund import main

if __name__ == "__main__":
    main(dataset_cls_name="sibr")

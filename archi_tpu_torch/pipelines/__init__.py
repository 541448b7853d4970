"""The parts of ``archi_tpu.pipelines`` that the data-manager service uses."""
